"""Mask-rule tests.

An independent brute-force mirror of the reference's ``Vanilla*Policy``
TF mask generators (``tests/test_base.py:33-67``) — the rule semantics are
specified twice, once in the framework and once here, and the tests assert
they agree (the same double-specification strategy the reference uses).
"""

import numpy as np
import pytest

from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule, make_rule
from tf_flash_attention_tpu.ops.reference import build_mask
from tf_flash_attention_tpu.schedule import build_schedule, sequence_orders
from tf_flash_attention_tpu.sync_modes import SYNC_MODES, make_sync_pack


def brute_force_mask(pack, *, kind, window=None, stride=1, causal=False):
    """Independent dense mask from first principles (loops over coords)."""
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)
    nq, nk = q_flat.size, k_flat.size
    mask = np.zeros((nq, nk), dtype=bool)
    for i in range(nq):
        for j in range(nk):
            if kind == "full":
                ok = True
            elif kind == "causal":
                ok = q_flat[i] >= k_flat[j]
            else:  # local
                ok = True
                for d in range(pack.ndim):
                    diff = abs(int(q_coords[d, i]) - int(k_coords[d, j]))
                    if diff % stride != 0 or diff // stride >= window:
                        ok = False
                if causal and q_flat[i] < k_flat[j]:
                    ok = False
            mask[i, j] = ok
    return mask


CASES = [
    dict(kind="full"),
    dict(kind="causal"),
    dict(kind="local", window=3, stride=1, causal=False),
    dict(kind="local", window=4, stride=2, causal=False),
    dict(kind="local", window=3, stride=1, causal=True),
    dict(kind="local", window=2, stride=4, causal=True),
]


def rule_for(case):
    if case["kind"] == "local":
        return LocalRule(
            window_size=case["window"],
            log2_stride_size=int(np.log2(case["stride"])),
            is_causal=case["causal"],
        )
    return make_rule(case["kind"])


@pytest.mark.parametrize("mode", SYNC_MODES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
@pytest.mark.parametrize("shapes", [((14,), (25,)), ((25,), (14,)), ((6, 9), (12, 5))],
                         ids=["1d-qlt", "1d-qgt", "2d"])
def test_rule_mask_matches_brute_force(mode, case, shapes):
    q_seq, k_seq = shapes
    pack = make_sync_pack(mode, q_seq, k_seq)
    rule = rule_for(case)
    got = build_mask(pack, rule).reshape(int(np.prod(q_seq)), int(np.prod(k_seq)))
    want = brute_force_mask(pack, **case)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", SYNC_MODES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_schedule_is_conservative(mode, case):
    """Every visible (q, k) element pair must live in a live tile pair."""
    q_seq, k_seq = (40,), (70,)
    pack = make_sync_pack(mode, q_seq, k_seq)
    rule = rule_for(case)
    block_q, block_kv = 16, 16
    sched = build_schedule(pack, rule, block_q, block_kv)
    mask = build_mask(pack, rule)
    nq, nk = mask.shape
    for i in range(nq):
        for j in range(nk):
            if mask[i, j]:
                assert sched.live[i // block_q, j // block_kv], (i, j)
    # table/counts consistent with live matrix
    for qi in range(sched.num_q_blocks):
        live_idx = np.flatnonzero(sched.live[qi])
        assert sched.kv_counts[qi] == live_idx.size
        np.testing.assert_array_equal(sched.kv_table[qi, : live_idx.size], live_idx)
    # transpose round-trips
    np.testing.assert_array_equal(sched.transpose().live, sched.live.T)


def test_local_rule_validation():
    with pytest.raises(ValueError):
        LocalRule(window_size=0)
    with pytest.raises(ValueError):
        LocalRule(window_size=1, log2_stride_size=31)


def test_full_rule_never_skips():
    pack = make_sync_pack("none_front", (40,), (40,))
    sched = build_schedule(pack, FullRule(), 16, 16)
    assert sched.live.all()


def test_causal_skips_upper_triangle_tiles():
    pack = make_sync_pack("none_front", (64,), (64,))
    sched = build_schedule(pack, CausalRule(), 16, 16)
    # strictly-above-diagonal tiles are dead
    for qi in range(4):
        for kj in range(4):
            assert sched.live[qi, kj] == (kj <= qi)


def test_transposed_schedule_tables():
    """The kv-outer backward kernel walks ``transpose()``: per kv block,
    the live q blocks in order, with the same interior/partial classes as
    the forward table read column-wise."""
    import numpy as np

    from tf_flash_attention_tpu.schedule import build_schedule
    from tf_flash_attention_tpu.sync_modes import make_sync_pack

    for mode, rule in [("none_front", CausalRule()),
                       ("scale_front", LocalRule(window_size=3,
                                                 log2_stride_size=1,
                                                 is_causal=True))]:
        pack = make_sync_pack(mode, (700,), (1000,))
        fwd = build_schedule(pack, rule, 128, 64)
        t = fwd.transpose()
        assert t.num_q_blocks == fwd.num_kv_blocks
        for kj in range(t.num_q_blocks):
            live_q = np.flatnonzero(fwd.live[:, kj])
            n = int(t.kv_counts[kj])
            assert n == live_q.size
            np.testing.assert_array_equal(t.kv_table[kj, :n], live_q)
            np.testing.assert_array_equal(
                t.needs_mask[kj, :n], fwd.partial[live_q, kj].astype(np.int32))
