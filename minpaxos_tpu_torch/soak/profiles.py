"""Workload profiles + open-loop arrival processes for the soak harness.

Two generator families, both seeded and byte-reproducible:

* **Profiles** — what the traffic looks like per command: key
  distribution (uniform or EXACT finite-support Zipf via inverse-CDF
  over the closed-form pmf — ``numpy``'s ``rng.zipf`` samples the
  unbounded Zeta distribution and is useless for pinning mass against
  a finite key space), read/write mix, and a log-uniform value-size
  envelope (wire values are fixed-width int64 lanes, so "size" is
  magnitude: how many value bytes survive a varint/delta encoder).
* **Arrivals** — WHEN commands enter: an open-loop Poisson process
  under a rate envelope (base rate x optional diurnal sine x optional
  burst window), sampled by thinning against the envelope's peak
  rate. Closed-loop swarms cannot produce overload (each session
  waits for its ack, so offered load collapses to service rate); an
  open-loop schedule keeps injecting on the clock, which is what
  makes the admission gate's shedding REAL rather than synthetic.

numpy + stdlib only — imported by swarm worker processes (no torch)
and by ``runtime/client.py``'s ``gen_workload(profile=...)`` hook. The
port's copy of the JAX package's ``soak/profiles.py``: the same seed
gives the same rows and arrival times, byte for byte.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

# Op codes mirrored from wire.messages.Op (PUT=1, GET=2) so this
# module stays importable without the wire package; pinned by test.
OP_PUT, OP_GET = 1, 2


# ------------------------------------------------------- exact Zipf

def zipf_pmf(n_keys: int, s: float) -> np.ndarray:
    """Closed-form Zipf(s) probability mass over ranks 1..n_keys:
    ``p(k) = k^-s / H(n_keys, s)``. float64, sums to 1 exactly enough
    for searchsorted sampling (the final cumsum entry is clamped)."""
    if n_keys < 1:
        raise ValueError(f"zipf needs n_keys >= 1: {n_keys}")
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = ranks ** -float(s)
    return w / w.sum()


def sample_zipf(n: int, n_keys: int, s: float,
                rng: np.random.Generator) -> np.ndarray:
    """``n`` exact Zipf(s) ranks in [0, n_keys) by inverse-CDF:
    uniform draws searchsorted into the pmf's cumsum. Rank 0 is the
    hottest key. Deterministic given the generator state."""
    cdf = np.cumsum(zipf_pmf(n_keys, s))
    cdf[-1] = 1.0  # clamp fp drift so u=1-eps can't fall off the end
    u = rng.random(n)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


# --------------------------------------------------------- profiles

@dataclass(frozen=True)
class WorkloadProfile:
    """What each command looks like. ``zipf_s > 0`` selects exact
    Zipf keys (rank 0 hottest); 0 = uniform. ``write_pct`` in
    [0, 100]. Values are log-uniform in magnitude over
    ``[1 << val_pow2_min, 1 << val_pow2_max)`` — the value-size
    distribution knob (uniform-magnitude traffic compresses/batches
    very differently from a heavy-tailed one)."""

    name: str = "uniform"
    key_space: int = 1024
    zipf_s: float = 0.0
    write_pct: int = 100
    val_pow2_min: int = 4
    val_pow2_max: int = 20

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadProfile":
        return cls(**d)


def profile_rows(profile: WorkloadProfile, n: int,
                 seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` workload rows ``(ops, keys, vals)`` drawn from the
    profile, byte-reproducible from ``seed`` (one PCG64 stream, fixed
    draw order: keys, ops, value exponents, value mantissas)."""
    rng = np.random.default_rng(seed)
    if profile.zipf_s > 0:
        keys = sample_zipf(n, profile.key_space, profile.zipf_s, rng)
    else:
        keys = rng.integers(0, profile.key_space, n).astype(np.int64)
    ops = np.where(rng.integers(0, 100, n) < profile.write_pct,
                   OP_PUT, OP_GET).astype(np.int64)
    # log-uniform magnitude: exponent uniform over [min, max), then a
    # uniform mantissa inside that octave — a heavy-tailed size mix
    exp = rng.integers(profile.val_pow2_min, profile.val_pow2_max, n)
    lo = (1 << exp.astype(np.int64))
    vals = lo + rng.integers(0, 1 << 30, n) % lo
    return ops, keys, vals.astype(np.int64)


#: named profiles a manifest refers to by string. key_space stays
#: well under the runtime's 4096-slot KV default so long soaks churn
#: values, not slots.
PROFILES: dict[str, WorkloadProfile] = {
    p.name: p for p in (
        WorkloadProfile(name="uniform"),
        WorkloadProfile(name="hot_zipf", zipf_s=1.2),
        WorkloadProfile(name="scorching_zipf", zipf_s=1.8,
                        key_space=256),
        WorkloadProfile(name="read_heavy", write_pct=10),
        WorkloadProfile(name="mixed", zipf_s=0.9, write_pct=50),
        WorkloadProfile(name="write_storm", write_pct=100,
                        val_pow2_min=16, val_pow2_max=20),
    )
}


def resolve_profile(spec: str | dict | WorkloadProfile) -> WorkloadProfile:
    """Accept a registry name, a dict (manifest JSON), or an already
    constructed profile."""
    if isinstance(spec, WorkloadProfile):
        return spec
    if isinstance(spec, str):
        try:
            return PROFILES[spec]
        except KeyError:
            raise ValueError(
                f"unknown profile {spec!r}; known: "
                f"{sorted(PROFILES)}") from None
    return WorkloadProfile.from_dict(spec)


# --------------------------------------------------------- arrivals

@dataclass(frozen=True)
class ArrivalSpec:
    """An open-loop arrival schedule: Poisson at ``rate_hz`` under an
    envelope. ``burst_x`` multiplies the rate inside the window
    ``[burst_t0_frac, burst_t1_frac) * duration_s`` (1.0 = no burst);
    ``diurnal_amp`` adds a ``1 + amp*sin(2*pi*t/period)`` modulation
    (a soak's compressed day). All times are offsets in seconds from
    the phase start."""

    rate_hz: float = 100.0
    duration_s: float = 5.0
    burst_x: float = 1.0
    burst_t0_frac: float = 0.0
    burst_t1_frac: float = 0.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 60.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalSpec":
        return cls(**d)

    def rate_at(self, t: np.ndarray) -> np.ndarray:
        """Instantaneous envelope rate (Hz) at offsets ``t``."""
        t = np.asarray(t, np.float64)
        r = np.full(t.shape, float(self.rate_hz))
        if self.diurnal_amp:
            r = r * (1.0 + self.diurnal_amp
                     * np.sin(2.0 * np.pi * t / self.diurnal_period_s))
        if self.burst_x != 1.0 and self.burst_t1_frac > self.burst_t0_frac:
            b0 = self.burst_t0_frac * self.duration_s
            b1 = self.burst_t1_frac * self.duration_s
            r = np.where((t >= b0) & (t < b1), r * self.burst_x, r)
        return np.maximum(r, 0.0)

    @property
    def peak_rate(self) -> float:
        base = self.rate_hz * (1.0 + max(self.diurnal_amp, 0.0))
        if self.burst_x > 1.0 and self.burst_t1_frac > self.burst_t0_frac:
            base *= self.burst_x
        return base


def arrival_times(spec: ArrivalSpec, seed: int) -> np.ndarray:
    """Seeded inhomogeneous-Poisson arrival offsets (seconds, sorted,
    float64) over ``[0, duration_s)`` by thinning: draw a homogeneous
    process at the envelope's peak rate, keep each point with
    probability ``rate(t)/peak``. Byte-reproducible: one PCG64
    stream, fixed draw order (exponential gaps, then uniforms)."""
    lam = spec.peak_rate
    if lam <= 0 or spec.duration_s <= 0:
        return np.empty(0, np.float64)
    rng = np.random.default_rng(seed)
    # enough exponential gaps to cover duration_s w.h.p.; top up the
    # rare shortfall deterministically from the same stream
    n_guess = int(lam * spec.duration_s + 6 * np.sqrt(lam * spec.duration_s)) + 16
    gaps = rng.exponential(1.0 / lam, n_guess)
    t = np.cumsum(gaps)
    while t[-1] < spec.duration_s:
        more = rng.exponential(1.0 / lam, n_guess)
        t = np.concatenate([t, t[-1] + np.cumsum(more)])
    t = t[t < spec.duration_s]
    keep = rng.random(len(t)) < spec.rate_at(t) / lam
    return t[keep]
