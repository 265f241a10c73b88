"""The slot writes of kernel K10 (their plain twins) equal the JAX
package's expressions, bit for bit (tolerance 0).

``slot_write`` in modes A and B against the reference's fused writes A
and B (models/minpaxos.py :538-575 and :765-800, transcribed below as
jnp over one replica and vmapped), and ``gather_rows`` against
ops/winner.py ``slot_winner`` + ``gather_row`` / ``gather_const`` in
the forms models/mencius.py writes. The inboxes are adversarial: many
rows on a few slots in both sections, ties inside a section, targets
outside the window, uint8 op values above 255, statuses on both sides
of COMMITTED and senders outside [0, R).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import winner as jwin
from minpaxos_tpu_torch.models.minpaxos import MsgBatch
from minpaxos_tpu_torch.ops import winner as twin

torch.set_num_threads(1)

B, M, S, R = 6, 48, 40, 5
ACCEPTED, COMMITTED = 3, 4


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def ri(lo, hi, shape=(B, M)):
        return rng.integers(lo, hi, shape).astype(np.int32)

    hot = rng.integers(0, S, (B, 4))
    tgt = np.where(rng.random((B, M)) < 0.6,  # most rows on four slots
                   np.take_along_axis(hot, rng.integers(0, 4, (B, M)), 1),
                   rng.integers(-3, S + 4, (B, M))).astype(np.int32)
    inbox = dict(ballot=ri(-1, 40), op=ri(0, 300), key_hi=ri(-5, 5), key_lo=ri(0, 99),
                 val_hi=ri(-9, 9), val_lo=ri(0, 1 << 20), cmd_id=ri(0, 1 << 16),
                 client_id=ri(-1, 7), src=ri(-2, R + 2))
    old = dict(ballot=ri(-1, 40, (B, S)),
               status=rng.choice([0, 2, 3, 4, 5], (B, S)).astype(np.uint8),
               op=ri(0, 4, (B, S)).astype(np.uint8),
               key_hi=ri(-5, 5, (B, S)), key_lo=ri(0, 99, (B, S)), val_hi=ri(-9, 9, (B, S)),
               val_lo=ri(0, 1 << 20, (B, S)), cmd_id=ri(0, 1 << 16, (B, S)),
               client_id=ri(-1, 7, (B, S)), votes=ri(0, 1 << R, (B, S)))
    return dict(tgt=tgt, sec=rng.random((B, M)) < 0.5, ok=rng.random((B, M)) < 0.7,
                inbox=inbox, old=old, me=ri(0, R, (B,)), dball=ri(0, 80, (B,)))


def _torch_args(x):
    T = torch.from_numpy
    inbox = MsgBatch(**{f: T(x["inbox"].get(f, np.zeros((B, M), np.int32)))
                        for f in MsgBatch._fields})
    return inbox, tuple(T(x["old"][f]) for f in twin.SLOT_COLS)


def _ref_write(mode, tgt, sec, ok, inbox, old, me, dball):
    """The reference's fused write A or B for one replica (``tgt`` is
    rel_i for A, where(fits, rel_p, rel_i) for B; ``sec`` is acc_ok
    for A, fits for B; ``ok`` is okA / okB)."""
    rows_m = jnp.arange(M, dtype=jnp.int32)
    key = jnp.full(S + 1, -1, jnp.int32).at[
        jnp.where(ok & (tgt >= 0) & (tgt <= S), tgt, S)].max(
        jnp.where(sec, M + rows_m, rows_m), mode="drop")[:S]
    hit = key >= 0
    sec_w = key >= M
    row = jnp.mod(key, M)
    me_bit = jnp.int32(1) << me
    src_bit = jnp.int32(1) << jnp.clip(inbox["src"], 0, R - 1)
    new = {f: jnp.where(hit, inbox[f][row], old[f])
           for f in ("key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id")}
    new["op"] = jnp.where(hit, inbox["op"][row].astype(jnp.uint8), old["op"])
    if mode == "A":
        new["ballot"] = jnp.where(hit, inbox["ballot"][row], old["ballot"])
        new["status"] = jnp.where(hit, jnp.uint8(ACCEPTED), old["status"])
        new["votes"] = jnp.where(hit, jnp.where(sec_w, src_bit[row], me_bit),
                                 old["votes"])
    else:
        new["ballot"] = jnp.where(hit, jnp.where(sec_w, dball, inbox["ballot"][row]),
                                  old["ballot"])
        new["status"] = jnp.where(hit, jnp.where(sec_w, jnp.uint8(ACCEPTED),
                                                 jnp.maximum(old["status"],
                                                             jnp.uint8(COMMITTED))),
                                  old["status"])
        new["votes"] = jnp.where(hit & sec_w, me_bit, old["votes"])
    return key, new


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_slot_write_matches_the_reference(mode, seed):
    x = _inputs(seed)
    okx = x["ok"] | x["sec"] if mode == "B" else x["ok"]
    want_key, want = jax.jit(jax.vmap(lambda *a: _ref_write(mode, *a)))(
        x["tgt"], x["sec"], okx, x["inbox"], x["old"], x["me"], x["dball"])
    inbox, old = _torch_args(x)
    new = twin.slot_write(twin.WRITE_A if mode == "A" else twin.WRITE_B, S,
                               torch.from_numpy(x["tgt"]), torch.from_numpy(x["sec"]),
                               torch.from_numpy(okx), inbox, old,
                               torch.from_numpy(x["me"]),
                               torch.from_numpy(x["dball"]) if mode == "B" else None,
                               n_replicas=R)
    key = np.asarray(want_key)  # the inputs reach hits, misses and both sections
    assert (key >= 0).sum() > 0 and (key < 0).sum() > 0
    assert (key >= M).any() and ((key >= 0) & (key < M)).any()
    for f, t in zip(twin.SLOT_COLS, new):
        a = np.asarray(want[f])
        assert a.dtype == t.numpy().dtype, f
        np.testing.assert_array_equal(a, t.numpy(), err_msg=f)


# (models/mencius.py's gather_rows forms: the ACCEPT / PIR / COMMIT
# write_rows and step 1's constant-ballot PROPOSE write)
FORMS = {
    "accept": (twin.SlotMode(twin.BAL_ROW, twin.ST_ACCEPTED, twin.V_KEEP), "row", "acc", None),
    "commit": (twin.SlotMode(twin.BAL_ROW, twin.ST_COMMIT, twin.V_KEEP), "row", "com", None),
    "pir": (twin.SlotMode(twin.BAL_ROW, twin.ST_ACCEPTED, twin.V_ME), "row", "acc", "me"),
    "propose": (twin.SlotMode(twin.BAL_CONST, twin.ST_ACCEPTED, twin.V_ME), 0, "acc", "me"),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("form", list(FORMS))
def test_gather_rows_matches_the_reference(form, seed):
    mode, ballot, status, votes = FORMS[form]
    x = _inputs(seed)
    rel = np.where(x["ok"] & (x["tgt"] >= 0) & (x["tgt"] < S), x["tgt"], S).astype(np.int32)
    win, hit = jax.jit(jax.vmap(lambda r, o: jwin.slot_winner(S, r, o)))(rel, x["ok"])
    inbox, old = x["inbox"], x["old"]

    def ref(win, hit, inbox, old, me):
        me_bit = (jnp.int32(1) << me)
        new = {f: jwin.gather_row(win, hit, inbox[f], old[f])
               for f in ("op", "key_hi", "key_lo", "val_hi", "val_lo", "cmd_id",
                         "client_id")}
        new["ballot"] = (jwin.gather_row(win, hit, inbox["ballot"], old["ballot"])
                         if ballot == "row" else jwin.gather_const(hit, 0, old["ballot"]))
        new["status"] = (jwin.gather_const(hit, ACCEPTED, old["status"]) if status == "acc"
                         else jnp.where(hit, jnp.maximum(old["status"], jnp.uint8(COMMITTED)),
                                        old["status"]))
        new["votes"] = (jwin.gather_const(hit, me_bit, old["votes"]) if votes
                        else old["votes"])
        return new

    want = jax.jit(jax.vmap(ref))(win, hit, inbox, old, x["me"])
    tin, told = _torch_args(x)
    new = twin.gather_rows(mode, torch.from_numpy(np.array(win)),
                           torch.from_numpy(np.array(hit)), tin, told,
                           torch.from_numpy(x["me"]), n_replicas=R)
    if votes is None:
        assert new[-1] is told[-1]  # kept, not copied
    for f, t in zip(twin.SLOT_COLS, new):
        np.testing.assert_array_equal(np.asarray(want[f]), t.numpy(), err_msg=f)
