"""Master binary — reference src/master/master.go flags (:16-17).

    python -m minpaxos_tpu_torch.cli.master -N 3 -port 7087
"""

from __future__ import annotations

import argparse
import signal
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser("minpaxos-master")
    p.add_argument("-port", type=int, default=7087, help="listen port")
    p.add_argument("-N", type=int, default=3, help="number of replicas")
    p.add_argument("-addr", default="127.0.0.1", help="listen address")
    p.add_argument("-ping", type=float, default=1.0,
                   help="liveness ping interval seconds (reference: 3s)")
    args = p.parse_args(argv)

    from minpaxos_tpu_torch.runtime.master import Master

    m = Master(args.addr, args.port, args.N, ping_s=args.ping)
    m.start()
    print(f"master: listening on {args.addr}:{args.port} for {args.N} "
          f"replicas", flush=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    m.stop()


if __name__ == "__main__":
    main()
