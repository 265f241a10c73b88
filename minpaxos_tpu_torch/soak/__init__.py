"""The soak harness's load side.

The port's copy of the JAX package's ``soak`` package, its load half:

* profiles — named workload profiles (exact Zipf hot-key skew,
             read/write mix, value-size distribution) and a seeded
             open-loop arrival process (Poisson under a diurnal and
             burst envelope). numpy + stdlib only.
* swarm    — OpenLoopSwarm: ClientSwarm's selector loop sharded across
             worker processes, deadline-based open-loop injection,
             per-shard exactly-once accounting merged at the driver.
             Workers import numpy, the stdlib, the port's wire codec,
             its master RPC helpers and ``obs/trace.py``: never torch,
             so a worker creates no CUDA context.

Not carried over yet (the scenario side): ``scenario.py`` (the phase
manifest, its driver and scorecard), the servers' ``phase`` verb and
the master's fan-out of it, the burn-rate admission arm, the soak CLI's
verdict and the paxtop soak stanza.
"""
