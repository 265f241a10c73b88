"""The port's resident loop with the paxray telemetry ring armed equals
the JAX package's, row for row (integers: tolerance 0).

MinPaxos (G=2 x R=5, W=64) and Mencius (G=2 x 5 owners, W=256), k=8
rounds per dispatch, three loaded dispatches and two drain dispatches,
at substeps 1 and 2: the per-dispatch (committed_total, in_flight), the
telemetry rows (``resident_telemetry``), the inject ring, the latency
histogram and every state leaf must equal the JAX run's (the KV tables
are large enough that neither engine drops a row, so they are compared
byte for byte). A ring shorter than the rounds run keeps the last
rows; the state is byte-identical with the ring on and off. Each JAX
configuration compiles once per file (module-scoped fixture).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.obs import recorder as jrec
from minpaxos_tpu.ops.telemetry import telemetry_row as jax_row
from minpaxos_tpu.parallel.sharded import ShardedCluster as JaxSharded
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.obs import recorder as trec
from minpaxos_tpu_torch.ops.telemetry import telemetry_row
from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

torch.set_num_threads(1)

SHAPES = {
    "minpaxos": dict(n_replicas=5, window=64, inbox=40, exec_batch=16, kv_pow2=10,
                     catchup_rows=8, recovery_rows=8),
    "mencius": dict(n_replicas=5, window=256, inbox=128, exec_batch=40, kv_pow2=10,
                    catchup_rows=8, recovery_rows=8, noop_delay=8),
}
LOAD = {"minpaxos": (16, 12), "mencius": (8, 4)}  # ext rows, proposals per round
G, K, RING, SHORT = 2, 8, 64, 5
CASES = [(p, s) for p in SHAPES for s in (1, 2)]


def _make(mod, proto, telemetry_rounds):
    ext, _ = LOAD[proto]
    cfg = (JaxCfg if mod == "jax" else MinPaxosConfig)(**SHAPES[proto])
    kw = dict(ext_rows=ext, key_space=64, seed=3, protocol=proto)
    sc = JaxSharded(cfg, G, **kw) if mod == "jax" else ShardedCluster(
        cfg, G, device="cpu", **kw)
    if proto == "minpaxos":
        sc.elect(0)
    sc.begin_resident(telemetry_rounds=telemetry_rounds)
    return sc


def _drive(mod, proto, substeps, telemetry_rounds=RING):
    sc = _make(mod, proto, telemetry_rounds)
    p = LOAD[proto][1]
    res = [sc.run_resident(K, p, substeps) for _ in range(3)]
    res += [sc.run_resident(K, 0, substeps) for _ in range(2)]
    tel = sc.resident_telemetry()
    inj = np.asarray(sc._inject_round.cpu() if mod == "port" else sc._inject_round)
    hist = sc.end_resident()
    if mod == "port":
        leaves = jax.tree_util.tree_leaves(to_numpy_state(sc.ss, single=False))
    else:
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(sc.ss)]
    return dict(res=res, tel=tel, inj=inj, hist=hist, leaves=leaves)


@pytest.fixture(scope="module")
def runs():
    return {(mod, proto, s): _drive(mod, proto, s)
            for proto, s in CASES for mod in ("jax", "port")}


@pytest.mark.parametrize("proto,substeps", CASES)
def test_telemetry_ring_matches_jax(runs, proto, substeps):
    j, t = runs[("jax", proto, substeps)], runs[("port", proto, substeps)]
    assert j["res"] == t["res"]
    assert j["res"][-1][1] == 0  # drained
    np.testing.assert_array_equal(j["tel"], t["tel"])
    np.testing.assert_array_equal(j["inj"], t["inj"])
    np.testing.assert_array_equal(j["hist"], t["hist"])
    assert len(j["leaves"]) == len(t["leaves"])
    for a, b in zip(j["leaves"], t["leaves"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tel = t["tel"]
    assert tel.shape == (5 * K, trec.N_TEL_FIELDS)
    # the rows account for the run: every commit, every assignment
    assert int(tel[:, trec.TEL_COMMITTED].sum()) == int(t["hist"].sum())
    assert int(tel[:, trec.TEL_INBOX_ROWS].sum()) > 0
    assert int(tel[-1, trec.TEL_IN_FLIGHT]) == 0
    assert (tel[:, trec.TEL_PREPARED] == G).all()


@pytest.mark.parametrize("proto", list(SHAPES))
def test_short_ring_keeps_the_last_rows(runs, proto):
    t = _drive("port", proto, 1, telemetry_rounds=SHORT)
    np.testing.assert_array_equal(t["tel"], runs[("jax", proto, 1)]["tel"][-SHORT:])


@pytest.mark.parametrize("proto", list(SHAPES))
def test_state_identical_with_the_ring_on_and_off(runs, proto):
    off = _drive("port", proto, 1, telemetry_rounds=0)
    on = runs[("port", proto, 1)]
    assert off["tel"].shape == (0, trec.N_TEL_FIELDS)
    assert off["res"] == on["res"]
    np.testing.assert_array_equal(off["inj"], on["inj"])
    np.testing.assert_array_equal(off["hist"], on["hist"])
    for a, b in zip(off["leaves"], on["leaves"]):
        np.testing.assert_array_equal(a, b)


def test_layout_equals_the_jax_recorder():
    assert trec.TEL_FIELD_NAMES == jrec.TEL_FIELD_NAMES
    assert trec.N_TEL_FIELDS == jrec.N_TEL_FIELDS
    for name in ("TEL_ROUND", "TEL_COMMITTED", "TEL_IN_FLIGHT", "TEL_ASSIGNED",
                 "TEL_INJECTED", "TEL_INBOX_ROWS", "TEL_CLAIM_ROWS",
                 "TEL_PREPARED", "TEL_INBOX_HWM"):
        assert getattr(trec, name) == getattr(jrec, name)
    vals = list(range(11, 11 + trec.N_TEL_FIELDS))
    np.testing.assert_array_equal(np.asarray(jax_row(*vals)), telemetry_row(*vals).numpy())
    buf = np.full((4, trec.N_TEL_FIELDS), -1, np.int32)
    buf[2, 0], buf[0, 0] = 9, 7
    np.testing.assert_array_equal(trec.telemetry_valid_rows(buf),
                                  jrec.telemetry_valid_rows(buf))
