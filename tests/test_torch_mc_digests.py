"""The digests of the states paxmc reaches: the JAX explorer's, the port's.

``tests/fixtures/paxmc_state_digests.json`` holds, for each run of
MC.json's smoke legs, each run of MC_FLEX.json's certified sweep and a
tiny leg per protocol, the blake2b digest of the sorted set of
canonical state keys the JAX package's explorer reaches
(``minpaxos_tpu_torch.verify.mc.state_digest``). Both explorers hash
the same bytes, so the port's explorer on the CPU (here) and on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``mc`` phase)
must reach the same digests.

Writing the fixture (the JAX explorer on the CPU, about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_mc_digests.py --write
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "paxmc_state_digests.json"
sys.path.insert(0, str(ROOT))

from minpaxos_tpu_torch.cli import mc as port_cli  # noqa: E402
from minpaxos_tpu_torch.verify import mc as port_mc  # noqa: E402


def _tools_mc():
    """The JAX package's CLI module (tools/mc.py), for its legs."""
    spec = importlib.util.spec_from_file_location("_ref_tools_mc",
                                                  ROOT / "tools" / "mc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_legs():
    """A tiny leg per protocol: tests/test_paxmc.py:241's bounds for
    minpaxos and classic, tests/test_paxref.py:221's for mencius."""
    b = port_mc.Bounds(max_depth=4, drops=1, dups=0, internal=1,
                       elections=0, n_cmds=1, propose_to=(0,))
    m = port_mc.Bounds(max_depth=4, drops=1, dups=0, internal=1,
                       elections=0, n_cmds=1, propose_to=(0, 1))
    return [("tiny-minpaxos", "minpaxos", b, {}),
            ("tiny-classic", "classic", b, {}),
            ("tiny-mencius", "mencius", m, {})]


def flex_legs():
    """MC_FLEX.json's runs: (label, n, q1, q2)."""
    from minpaxos_tpu_torch.verify.quorum_golden import GOLDEN_THRESHOLDS

    return [(f"flex-certified n={n} q1={q1} q2={q2}", n, q1, q2)
            for n in (3, 4, 5) for q1, q2 in GOLDEN_THRESHOLDS[n]]


def jax_digest(protocol, bounds: dict, kw: dict, refine: bool = False):
    """(states, transitions, digest) of the JAX explorer's run, its keys
    taken by a subclass that records ``_key``'s returns."""
    from minpaxos_tpu.verify.mc import Bounds, Explorer
    from minpaxos_tpu.verify.refine import RefinementExplorer

    base = RefinementExplorer if refine else Explorer

    class Recording(base):
        def _key(self, node):
            k = super()._key(node)
            self.keys.add(k)
            return k

    ex = Recording(protocol, Bounds(**bounds), **kw)
    ex.keys = set()
    res = ex.run()
    return res.states, res.transitions, port_mc.state_digest(ex.keys)


def write_fixture(path=FIXTURE) -> dict:
    doc = {"format": "paxmc-state-digests-v1",
           "digest": "blake2b(digest_size=16) of the sorted, concatenated "
                     "16-byte canonical state keys the JAX explorer's "
                     "_key returned over the run",
           "runs": {}}

    def put(label, protocol, bounds, kw, refine=False):
        states, transitions, digest = jax_digest(protocol, bounds, kw, refine)
        doc["runs"][label] = dict(protocol=protocol, bounds=bounds, kw=kw,
                                  refine=refine, states=states,
                                  transitions=transitions, digest=digest)
        print(label, states, transitions, digest, flush=True)

    for label, proto, b, kw in port_cli._smoke_legs() + tiny_legs():
        put(label, proto, b.to_dict(), kw)
    for label, n, q1, q2 in flex_legs():
        put(label, "minpaxos", port_cli._flex_certified_bounds(n).to_dict(),
            {"q1": q1, "q2": q2, "n_replicas": n}, refine=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    return doc


def _fixture() -> dict:
    return json.loads(FIXTURE.read_text())["runs"]


SMOKE = [label for label, *_ in port_cli._smoke_legs()]


def test_port_legs_are_the_reference_legs():
    """The port CLI's smoke and certified-sweep bounds are tools/mc.py's."""
    ref = _tools_mc()
    assert [(lab, p, b.to_dict(), kw) for lab, p, b, kw in ref._smoke_legs()] \
        == [(lab, p, b.to_dict(), kw) for lab, p, b, kw in port_cli._smoke_legs()]
    assert [(lab, p, b.to_dict(), kw) for lab, p, b, kw in ref._refine_legs()] \
        == [(lab, p, b.to_dict(), kw) for lab, p, b, kw in port_cli._refine_legs()]
    assert ref._mutant_bounds().to_dict() == port_cli._mutant_bounds().to_dict()
    assert ref._flex_mutant_bounds().to_dict() == \
        port_cli._flex_mutant_bounds().to_dict()
    assert ref._skip_quorum2_bounds().to_dict() == \
        port_cli._skip_quorum2_bounds().to_dict()
    assert ref.FLEX_MUTANT == port_cli.FLEX_MUTANT
    assert ref.SPEC_PAIR == port_cli.SPEC_PAIR
    fixture = _fixture()
    for label, n, q1, q2 in flex_legs():
        assert fixture[label]["bounds"] == json.loads(json.dumps(
            port_cli._flex_certified_bounds(n).to_dict()))


@pytest.mark.parametrize("label", SMOKE)
def test_jax_explorer_digest_equals_the_fixture(label):
    want = _fixture()[label]
    got = jax_digest(want["protocol"], want["bounds"], want["kw"])
    assert got == (want["states"], want["transitions"], want["digest"])


@pytest.mark.parametrize("label", SMOKE)
def test_port_explorer_digest_equals_the_fixture(label):
    want = _fixture()[label]
    ex = port_mc.Explorer(want["protocol"], port_mc.Bounds(**want["bounds"]),
                          **want["kw"], device="cpu")
    res = ex.run()
    assert res.ok and res.drained
    assert (res.states, res.transitions, port_mc.state_digest(ex.seen)) == \
        (want["states"], want["transitions"], want["digest"])


def test_fixture_counts_are_the_committed_records():
    """The fixture's runs carry MC.json's and MC_FLEX.json's counts."""
    fixture = _fixture()
    mc_json = json.loads((ROOT / "MC.json").read_text())
    for label, run in zip(SMOKE, mc_json["runs"]):
        assert (fixture[label]["states"], fixture[label]["transitions"]) == \
            (run["states"], run["transitions"]), label
    flex = json.loads((ROOT / "MC_FLEX.json").read_text())
    for (label, n, q1, q2), run in zip(flex_legs(), flex["runs"]):
        assert (run["n_replicas"], run["q1"], run["q2"]) == (n, q1, q2)
        assert (fixture[label]["states"], fixture[label]["transitions"]) == \
            (run["states"], run["transitions"]), label


def _records():
    return {name: json.loads((ROOT / name).read_text())
            for name in ("MC.json", "MC_FLEX.json")}


def _sections():
    return [(name, key) for name, rec in _records().items()
            for key, v in rec.items() if isinstance(v, (dict, list))]


@pytest.mark.parametrize("name,key", _sections(),
                         ids=[f"{n}:{k}" for n, k in _sections()])
def test_chip_smoke_count_gate_flags_a_lost_section(name, key):
    """chip_smoke.py's mc gate (``count_diffs``) passes a verdict equal to
    the committed record, and fails one that lost a section of it, or
    holds something else there."""
    import chip_smoke

    want = _records()[name]
    assert chip_smoke.count_diffs(json.loads(json.dumps(want)), want) == []
    for other in (None, 0, "x"):
        got = {k: v for k, v in want.items() if k != key}
        if other is not None:
            got[key] = other
        assert chip_smoke.count_diffs(got, want), (key, other)


def test_legs_record_the_step_share_of_each_wall():
    """Each leg's stats carry ``step_s``, the step calls' part of its wall."""
    legs = port_cli.Legs("cpu", log=lambda *a, **k: None)
    _label, proto, bounds, kw = tiny_legs()[0]
    ex = port_mc.Explorer(proto, bounds, **kw, device="cpu")
    legs.run("tiny", ex, ex.run)
    st = legs.stats[-1]
    assert st["step_calls"] > 0
    assert 0 < st["step_s"] <= st["wall_s"]


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_mc_digests.py --write")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixture()
