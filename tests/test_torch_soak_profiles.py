"""The soak harness's workload profiles and open-loop arrivals on the port
(``minpaxos_tpu_torch/soak/profiles.py``) against the JAX package's: the
same seeds give the same arrays, byte for byte, for every registered
profile, and the port's generators keep the reference's properties
(the mirrors of ``tests/test_soak.py``'s profile and arrival tests)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minpaxos_tpu.soak import profiles as ref
from minpaxos_tpu_torch.soak import profiles as port
from minpaxos_tpu_torch.soak.profiles import (
    OP_GET,
    OP_PUT,
    PROFILES,
    ArrivalSpec,
    arrival_times,
    profile_rows,
    resolve_profile,
    sample_zipf,
    zipf_pmf,
)

torch.set_num_threads(1)

SEEDS = (0, 11, 42)
SIZES = (1, 1000, 65536)
GRID = [(name, seed, n) for name in PROFILES for seed in SEEDS for n in SIZES]

# with and without the diurnal and burst envelopes, and the empty ones
SPECS = {
    "plain": ArrivalSpec(rate_hz=150.0, duration_s=3.0),
    "burst": ArrivalSpec(rate_hz=300.0, duration_s=12.0, burst_x=9.0,
                         burst_t0_frac=0.2, burst_t1_frac=0.45),
    "diurnal": ArrivalSpec(rate_hz=200.0, duration_s=8.0, diurnal_amp=0.3,
                           diurnal_period_s=4.0),
    "both": ArrivalSpec(rate_hz=200.0, duration_s=8.0, burst_x=5.0,
                        burst_t0_frac=0.25, burst_t1_frac=0.5,
                        diurnal_amp=0.3, diurnal_period_s=4.0),
    "damped_burst": ArrivalSpec(rate_hz=400.0, duration_s=5.0, burst_x=0.25,
                                burst_t0_frac=0.4, burst_t1_frac=0.8),
    "negative_diurnal": ArrivalSpec(rate_hz=100.0, duration_s=6.0,
                                    diurnal_amp=-1.5, diurnal_period_s=3.0),
    "zero_rate": ArrivalSpec(rate_hz=0.0),
    "zero_duration": ArrivalSpec(rate_hz=50.0, duration_s=0.0),
}


def _ref_spec(spec: ArrivalSpec) -> ref.ArrivalSpec:
    return ref.ArrivalSpec.from_dict(spec.to_dict())


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ------------------------------------------------- against the reference

def test_the_registry_is_the_reference_registry():
    assert list(PROFILES) == list(ref.PROFILES)
    for name, p in PROFILES.items():
        assert p.to_dict() == ref.PROFILES[name].to_dict()
    assert (OP_PUT, OP_GET) == (ref.OP_PUT, ref.OP_GET)


@pytest.mark.parametrize("name,seed,n", GRID)
def test_profile_rows_equal_the_reference(name, seed, n):
    got = profile_rows(PROFILES[name], n, seed)
    want = ref.profile_rows(ref.PROFILES[name], n, seed)
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.parametrize("name,seed,n", GRID)
def test_zipf_equals_the_reference(name, seed, n):
    """The pmf with a tolerance of 0 and the sampler's ranks, at each
    profile's key space and exponent (s = 0 for the uniform ones)."""
    p = PROFILES[name]
    assert _same(zipf_pmf(p.key_space, p.zipf_s), ref.zipf_pmf(p.key_space, p.zipf_s))
    got = sample_zipf(n, p.key_space, max(p.zipf_s, 0.9), np.random.default_rng(seed))
    want = ref.sample_zipf(n, p.key_space, max(p.zipf_s, 0.9), np.random.default_rng(seed))
    assert _same(got, want)


def test_zipf_rejects_an_empty_key_space_as_the_reference_does():
    for mod in (port, ref):
        with pytest.raises(ValueError, match="n_keys >= 1"):
            mod.zipf_pmf(0, 1.2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("what", sorted(SPECS))
def test_arrival_times_equal_the_reference(what, seed):
    spec = SPECS[what]
    assert _same(arrival_times(spec, seed), ref.arrival_times(_ref_spec(spec), seed))


@pytest.mark.parametrize("what", sorted(SPECS))
def test_rate_envelope_equals_the_reference(what):
    spec = SPECS[what]
    t = np.linspace(-1.0, spec.duration_s + 1.0, 4097)
    assert _same(spec.rate_at(t), _ref_spec(spec).rate_at(t))
    assert spec.peak_rate == _ref_spec(spec).peak_rate


@pytest.mark.parametrize("name", list(PROFILES))
def test_resolve_profile_as_the_reference(name):
    p = PROFILES[name]
    assert resolve_profile(name) is p
    assert resolve_profile(p) is p
    assert resolve_profile(p.to_dict()) == p
    assert port.WorkloadProfile.from_dict(p.to_dict()) == p
    assert resolve_profile(p.to_dict()).to_dict() == ref.resolve_profile(
        ref.PROFILES[name].to_dict()).to_dict()
    spec = SPECS["both"]
    assert ArrivalSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == _ref_spec(spec).to_dict()
    for mod in (port, ref):
        with pytest.raises(ValueError, match="unknown profile"):
            mod.resolve_profile("nope")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(PROFILES))
def test_gen_workload_profile_hook_equals_the_reference(name, seed):
    from minpaxos_tpu.runtime.client import gen_workload as ref_gen
    from minpaxos_tpu_torch.runtime.client import gen_workload

    for spec in (name, PROFILES[name].to_dict(), PROFILES[name]):
        got = gen_workload(4096, seed=seed, profile=spec)
        want = ref_gen(4096, seed=seed, profile=name)
        for g, w in zip(got, want):
            assert _same(g, w)
    # the legacy knobs are ignored under a profile, as in the reference
    got = gen_workload(512, conflict_pct=50, key_range=7, zipf_s=1.5,
                       write_pct=0, seed=seed, profile=name)
    for g, w in zip(got, profile_rows(PROFILES[name], 512, seed)):
        assert _same(g, w)


@pytest.mark.parametrize("kw", [
    {}, {"conflict_pct": 30, "key_range": 1000}, {"zipf_s": 1.3, "key_range": 500},
    {"write_pct": 10, "seed": 7}, {"conflict_pct": 100, "write_pct": 50, "seed": 3},
], ids=["defaults", "conflict", "zipf", "reads", "all_conflict"])
def test_gen_workload_legacy_knobs_unchanged(kw):
    from minpaxos_tpu.runtime.client import gen_workload as ref_gen
    from minpaxos_tpu_torch.runtime.client import gen_workload

    for g, w in zip(gen_workload(20000, **kw), ref_gen(20000, **kw)):
        assert _same(g, w)


def test_profile_op_codes_mirror_the_ports_wire():
    from minpaxos_tpu_torch.wire.messages import Op

    assert OP_PUT == int(Op.PUT)
    assert OP_GET == int(Op.GET)


# ------------------------------------- the reference's properties, on the port

def test_zipf_pmf_closed_form():
    pmf = zipf_pmf(1024, 1.2)
    assert pmf.shape == (1024,)
    assert abs(pmf.sum() - 1.0) < 1e-12
    assert pmf[0] / pmf[1] == pytest.approx(2.0 ** 1.2, rel=1e-12)
    assert np.all(np.diff(pmf) < 0)


def test_zipf_sample_mass_pinned_against_closed_form():
    n, n_keys, s = 200_000, 1024, 1.2
    ranks = sample_zipf(n, n_keys, s, np.random.default_rng(99))
    assert ranks.min() >= 0 and ranks.max() < n_keys
    pmf = zipf_pmf(n_keys, s)
    for top in (1, 8, 64):
        want = pmf[:top].sum()
        got = float(np.mean(ranks < top))
        tol = 4.5 * np.sqrt(want * (1 - want) / n)
        assert abs(got - want) < tol, (top, got, want, tol)


def test_zipf_sampler_deterministic():
    a = sample_zipf(1000, 256, 1.8, np.random.default_rng(7))
    b = sample_zipf(1000, 256, 1.8, np.random.default_rng(7))
    assert np.array_equal(a, b)


def test_profile_rows_reproducible_and_shaped():
    prof = PROFILES["mixed"]
    ops, keys, vals = profile_rows(prof, 20_000, seed=5)
    ops2, keys2, vals2 = profile_rows(prof, 20_000, seed=5)
    assert (np.array_equal(ops, ops2) and np.array_equal(keys, keys2)
            and np.array_equal(vals, vals2))
    assert set(np.unique(ops)) <= {OP_PUT, OP_GET}
    assert abs(float(np.mean(ops == OP_PUT)) - 0.50) < 0.02
    assert keys.min() >= 0 and keys.max() < prof.key_space
    assert vals.min() >= 1 << prof.val_pow2_min
    assert vals.max() < 1 << prof.val_pow2_max


def test_arrival_schedule_byte_reproducible():
    spec = SPECS["both"]
    a = arrival_times(spec, seed=42)
    assert a.dtype == np.float64 and np.array_equal(a, arrival_times(spec, seed=42))
    assert not np.array_equal(a, arrival_times(spec, seed=43))
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 8.0


def test_arrival_burst_envelope_density():
    spec = ArrivalSpec(rate_hz=400.0, duration_s=10.0, burst_x=4.0,
                       burst_t0_frac=0.2, burst_t1_frac=0.4)
    t = arrival_times(spec, seed=9)
    in_burst = np.sum((t >= 2.0) & (t < 4.0))
    outside = len(t) - in_burst
    assert in_burst == pytest.approx(3200, abs=5 * np.sqrt(3200))
    assert outside == pytest.approx(3200, abs=5 * np.sqrt(3200))
    assert (in_burst / 2.0) / (outside / 8.0) == pytest.approx(4.0, rel=0.15)


def test_arrival_rate_envelope_math():
    spec = ArrivalSpec(rate_hz=100.0, duration_s=10.0, burst_x=6.0,
                       burst_t0_frac=0.5, burst_t1_frac=0.6,
                       diurnal_amp=0.5, diurnal_period_s=10.0)
    assert spec.peak_rate == pytest.approx(100.0 * 1.5 * 6.0)
    r = spec.rate_at(np.array([0.0, 2.5, 5.5, 7.5]))
    assert r[0] == pytest.approx(100.0)
    assert r[1] == pytest.approx(150.0)
    assert r[2] == pytest.approx(600.0 * (1 + 0.5 * np.sin(2 * np.pi * 0.55)))
    assert r[3] == pytest.approx(50.0)
    assert len(arrival_times(ArrivalSpec(rate_hz=0.0), 1)) == 0
