"""Port dedup pass (point_cloud_tpu_torch/ops/dedup.py) against the reference.

Same numpy inputs (built by ``pass_args`` with the reference's f32
roundings) through the JAX pass and the port's, at a 2^15 bucket. The
NumPy host half (``collect_dedup`` and the functions it calls) is held
bit for bit against the reference's on the same packed rows, with forced
hash collisions, hex-edge x == 0.0 rows and near ties.

Comparison rule: ``winner`` exactly; ``perm`` and ``suspect`` exactly
except inside runs that either side flags as a near-tie, because XLA:CPU
may fma-contract the JAX distance chain (docs/PERF_TPU_V5E.md, "Backend
fma contraction") while torch's eager ops never fuse: two rows 1 ulp apart
can swap in the JAX order. Inside those runs the port's order must be
the oracle's (host distance bits, then arrival). For the same reason the
port's distances are held bit-exactly against the NumPy oracle
``host_keys_full``, and against the JAX distances only within 2 ulps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from point_cloud_tpu.core.metadata import MetadataConfig
from point_cloud_tpu.ops import dedup as jd
from point_cloud_tpu_torch.ops import dedup as td


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores, and torch's parallel regions wait at a
    barrier for every thread, so a descheduled thread stalls each small
    op (three 64x64 CPU frames took 90 s at 8 threads beside six busy
    processes on 8 cores, 0.4 s at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

N_BUCKET = 1 << 15
I32_MAX = 2**31 - 1


def batch_positions(kind, seed):
    rng = np.random.default_rng(seed)
    n = 30_000
    if kind == "sparse":
        pos = rng.uniform(-300, 300, (n, 3))
    elif kind == "dense":
        pos = rng.uniform(-2, 2, (n, 3))
        pos[: n // 3] = np.round(pos[: n // 3] * 8) / 8  # exact duplicates
    elif kind == "far":
        # |p| ~ 500 with tiny offsets: the cancellation-heavy near-ties
        pos = 500.0 + rng.uniform(-0.05, 0.05, (n, 3))
        pos[::7, 0] = 0.0  # hex edge x == 0.0
    else:
        raise ValueError(kind)
    pos = pos.astype(np.float32)
    pad = np.zeros((N_BUCKET, 3), np.float32)
    pad[:n] = pos
    valid = np.zeros(N_BUCKET, bool)
    valid[:n] = True
    return pad, valid


def grid(hierarchy):
    config = MetadataConfig()
    cell_size = config.cell_size(hierarchy)
    return cell_size, config.sub_cell_size(cell_size)


def jax_args(pos, valid, cell_size, sub_cell_size):
    return (
        jnp.asarray(pos), jnp.asarray(valid),
        jnp.float32(np.float32(cell_size)),
        jnp.float32(np.float32(sub_cell_size) / np.float32(2.0)),
    )


@jax.jit
def _jax_run_flags(positions, valid, cell_size, sub_cell_radius):
    ch_s, sh_s, db_s, perm, _, _, _ = jd._hash_sort(
        positions, valid, cell_size, sub_cell_radius
    )
    same = (ch_s == jnp.roll(ch_s, 1)) & (sh_s == jnp.roll(sh_s, 1))
    near = jd._near_tie_mask(same, db_s, positions[perm], ch_s != I32_MAX)
    return same, near


def _port_run_flags(positions, valid, cell_size, sub_cell_radius):
    ch_s, sh_s, db_s, perm, _, _, _ = td._hash_sort(
        positions, valid, cell_size, sub_cell_radius
    )
    same, _ = td._first_of_run(ch_s, sh_s)
    near = td._near_tie_mask(same, db_s, positions[perm.long()],
                             ch_s != I32_MAX)
    return same.numpy(), near.numpy()


def near_tie_rows(same, near):
    """Rows whose run (contiguous equal-hash rows) holds a near-tie."""
    run = np.cumsum(~same) - 1
    run -= run.min()
    bad = np.zeros(run.max() + 1, bool)
    bad[run[near]] = True
    return bad[run]


def excluded_rows(pos, valid, cell_size, sub_cell_size):
    """(rows in a near-tie run of either side, the port's same-run flags)."""
    targs = td.pass_args(pos, valid, cell_size, sub_cell_size, "cpu")
    jflags = [np.asarray(a) for a in
              _jax_run_flags(*jax_args(pos, valid, cell_size, sub_cell_size))]
    same, near = _port_run_flags(*targs)
    return near_tie_rows(same, near) | near_tie_rows(*jflags), same


def assert_perm_matches(got, ref, excluded, pos, cell_size, sub_cell_size):
    excluded, same = excluded
    assert excluded.mean() < 0.5  # the comparison is not vacuous
    assert np.array_equal(got[~excluded], ref[~excluded])
    # inside near-tie runs: the same rows, in the oracle's order
    rows = np.nonzero(excluded)[0]
    assert np.array_equal(np.sort(got[rows]), np.sort(ref[rows]))
    dist = jd.host_keys_full(pos, cell_size, sub_cell_size)[2].view(np.int32)
    in_run = rows[1:][same[rows[1:]] & (rows[1:] == rows[:-1] + 1)]
    a, b = got[in_run - 1], got[in_run]
    assert np.all((dist[a] < dist[b]) | ((dist[a] == dist[b]) & (a < b)))


def unpack(packed):
    packed = np.asarray(packed)
    return (packed & ((1 << 29) - 1), (packed >> 30) & 1 == 1,
            (packed >> 29) & 1 == 1)


CASES = [("sparse", 0), ("sparse", 5), ("dense", 6), ("dense", 9),
         ("far", 12), ("far", 14)]


@pytest.mark.parametrize("kind,hierarchy", CASES)
def test_light_pass_matches_jax(kind, hierarchy):
    pos, valid = batch_positions(kind, seed=hierarchy)
    cs, scs = grid(hierarchy)
    got = td.dedup_pass_light(*td.pass_args(pos, valid, cs, scs, "cpu"))
    ref = jd.dedup_pass_light(*jax_args(pos, valid, cs, scs))
    g_perm, g_win, g_sus = unpack(got.numpy())
    r_perm, r_win, r_sus = unpack(ref)
    excluded = excluded_rows(pos, valid, cs, scs)
    assert_perm_matches(g_perm, r_perm, excluded, pos, cs, scs)
    assert np.array_equal(g_win, r_win)
    assert np.array_equal(g_sus[~excluded[0]], r_sus[~excluded[0]])


@pytest.mark.parametrize("kind,hierarchy", CASES[::2])
def test_full_pass_matches_jax_and_host_keys(kind, hierarchy):
    pos, valid = batch_positions(kind, seed=hierarchy + 1)
    cs, scs = grid(hierarchy)
    next_cs = np.float32(cs) / np.float32(2.0)
    targs = td.pass_args(pos, valid, cs, scs, "cpu")
    got = [o.numpy() for o in
           td.dedup_pass(*targs, td.f32_scalar(next_cs, "cpu"))]
    ref = [np.asarray(o) for o in
           jd.dedup_pass(*jax_args(pos, valid, cs, scs), jnp.float32(next_cs))]
    perm, winner, valid_s, cell_s, sub_s, dist_s, next_s, suspect = got
    excluded = excluded_rows(pos, valid, cs, scs)
    assert_perm_matches(perm, ref[0], excluded, pos, cs, scs)
    for name, i in [("winner", 1), ("valid_s", 2)]:
        assert np.array_equal(got[i], ref[i]), name
    assert np.array_equal(suspect[~excluded[0]], ref[7][~excluded[0]])

    # distances: bit-exact vs the NumPy/C++ oracle; vs XLA:CPU within the
    # reference's own fma-drift band (_near_tie_mask: 8 ulps, or
    # 64 * |p|_max * sqrt(d) * 2^-24), compared row by row on the oracle
    h_cell, h_sub, h_dist, h_next = jd.host_keys_full(pos[perm], cs, scs)
    assert np.array_equal(dist_s.view(np.uint32), h_dist.view(np.uint32))
    j_dist = jd.host_keys_full(pos[ref[0]], cs, scs)[2]
    ulps = np.abs(j_dist.view(np.int32).astype(np.int64)
                  - ref[5].view(np.int32).astype(np.int64))
    band = (np.float32(64 * 2.0**-24) * np.abs(pos[ref[0]]).max(axis=1)
            * np.sqrt(j_dist))
    assert np.all((ulps <= 8) | (np.abs(ref[5] - j_dist) <= band))
    assert np.array_equal(cell_s, h_cell)
    assert np.array_equal(sub_s, h_sub)
    assert np.array_equal(next_s, h_next)


@pytest.mark.parametrize("kind,hierarchy", CASES)
def test_keys_match_numpy_oracle(kind, hierarchy):
    pos, _ = batch_positions(kind, seed=hierarchy + 2)
    cs, scs = grid(hierarchy)
    radius = np.float32(scs) / np.float32(2.0)
    p = torch.from_numpy(pos)
    cell, sub, dist = td.hex_keys(p, np.float32(cs), radius)
    nxt = td.torch_cell_index(p, np.float32(cs) / np.float32(2.0))
    h_cell, h_sub, h_dist, h_next = jd.host_keys_full(pos, cs, scs)
    assert np.array_equal(cell.numpy(), h_cell)
    assert np.array_equal(sub.numpy(), h_sub)
    assert np.array_equal(dist.numpy().view(np.uint32), h_dist.view(np.uint32))
    assert np.array_equal(nxt.numpy(), h_next)


def resident_case(seed):
    rng = np.random.default_rng(seed)
    level0 = rng.uniform(-50, 50, (40_000, 3)).astype(np.float32)
    extras = rng.uniform(-50, 50, (3_000, 3)).astype(np.float32)
    rows = rng.choice(len(level0), 20_000, replace=False).astype(np.int32)
    src = np.concatenate([rows, ~np.arange(len(extras), dtype=np.int32)])
    src = src[rng.permutation(len(src))]
    positions = np.where((src >= 0)[:, None], level0[np.maximum(src, 0)],
                         extras[np.where(src < 0, ~src, 0)])
    return level0, extras, src, positions


@pytest.mark.parametrize("hierarchy", [1, 4])
def test_resident_dispatch_equals_fresh_upload(hierarchy):
    level0, extras, src, positions = resident_case(seed=hierarchy)
    cs, scs = grid(hierarchy)
    h0 = td.dispatch_dedup(level0, cs, scs, device="cpu")
    res = td.dispatch_dedup_resident(h0["pos_dev"], src, extras, cs, scs)
    fresh = td.dispatch_dedup(positions, cs, scs, device="cpu")
    assert res["n"] == fresh["n"] == len(src)
    assert np.array_equal(td.packed_host(res), td.packed_host(fresh))

    # and the same packed rows as the reference's resident pass
    n_pad = td.pad_to_bucket(len(src), minimum=1 << 15)
    src_pad = np.full(n_pad, I32_MAX, np.int32)
    src_pad[: len(src)] = src
    ext_pad = np.zeros((td.pad_to_bucket(len(extras)), 3), np.float32)
    ext_pad[: len(extras)] = extras
    l0_pad = np.zeros((td.pad_to_bucket(len(level0), 1 << 15), 3), np.float32)
    l0_pad[: len(level0)] = level0
    ref = jd.dedup_pass_resident(
        jnp.asarray(l0_pad), jnp.asarray(src_pad), jnp.asarray(ext_pad),
        jnp.float32(np.float32(cs)),
        jnp.float32(np.float32(scs) / np.float32(2.0)),
    )
    got = td.packed_host(res)
    g_perm, g_win, _ = unpack(got)
    r_perm, r_win, _ = unpack(np.asarray(ref)[: len(src)])
    assert np.array_equal(g_perm, r_perm)
    assert np.array_equal(g_win, r_win)


def test_dispatch_auto_chooses_resident_for_majority_resident_levels():
    level0, extras, src, positions = resident_case(seed=3)
    cs, scs = grid(2)
    h0 = td.dispatch_dedup(level0, cs, scs, device="cpu")
    handle, resident, src_out, src_arr = td.dispatch_dedup_auto(
        h0["pos_dev"], src, positions, cs, scs, device="cpu"
    )
    assert resident is h0["pos_dev"] and src_out is src
    assert np.array_equal(src_arr, src)
    # a mostly-foreign level re-bases with a fresh upload
    foreign = np.where(src >= 0, ~np.int32(0), src).astype(np.int32)
    handle2, resident2, src2, src_arr2 = td.dispatch_dedup_auto(
        h0["pos_dev"], foreign, positions, cs, scs, device="cpu"
    )
    assert src2 is None and resident2 is handle2["pos_dev"]
    assert np.array_equal(src_arr2, np.arange(len(positions)))
    assert np.array_equal(td.packed_host(handle), td.packed_host(handle2))


def test_pass_args_roundings_match_reference():
    pos, valid = batch_positions("sparse", 1)
    cs, scs = grid(3)
    p, v, c, r = td.pass_args(pos, valid, cs, scs, "cpu")
    assert p.dtype == torch.float32 and v.dtype == torch.bool
    assert c.item() == np.float32(cs)
    assert r.item() == np.float32(scs) / np.float32(2.0)
    assert c.dim() == 0 and r.dim() == 0


# --- the NumPy host half (collect_dedup and what it calls) ----------------


def adversarial_host_positions(seed):
    """Random rows, exact duplicates, |p| ~ 500 near-ties and hex-edge
    x == 0.0 rows, shuffled together."""
    rng = np.random.default_rng(seed)
    parts = [
        rng.uniform(-300, 300, (4000, 3)),
        np.round(rng.uniform(-2, 2, (3000, 3)) * 8) / 8,
        500.0 + rng.uniform(-0.05, 0.05, (3000, 3)),
    ]
    pos = np.concatenate(parts).astype(np.float32)
    pos[::5, 0] = 0.0
    return pos[rng.permutation(len(pos))]


HOST_CASES = [("random", 0), ("random", 6), ("random", 12), ("collide", 3),
              ("collide", 9)]


@pytest.mark.parametrize("kind,hierarchy", HOST_CASES)
def test_collect_dedup_matches_reference(kind, hierarchy, monkeypatch):
    """Both host halves take the same packed rows (the port's pass on the
    CPU); every output must agree bit for bit. ``collide`` forces 1-bit
    hashes, so most runs mix keys and resolve on the host."""
    pos = adversarial_host_positions(seed=hierarchy)
    if kind == "collide":
        orig = td._hash_cols
        monkeypatch.setattr(td, "_hash_cols",
                            lambda cols, primes: orig(cols, primes) & 1)
    cs, scs = grid(hierarchy)
    handle = td.dispatch_dedup(pos, cs, scs, device="cpu")
    packed = td.packed_host(handle)
    got = td.collect_dedup(handle, pos, cs, scs)
    ref = jd.collect_dedup({"n": len(pos), "packed": packed}, pos, cs, scs)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(
            g.view(np.uint8), r.view(np.uint8))
    suspects = ((packed >> 29) & 1).sum()
    assert suspects > (len(pos) // 2 if kind == "collide" else 0)
    # the port's own dedup_batch_host is the same dispatch + collect
    again = td.dedup_batch_host(pos, cs, scs, device="cpu")
    assert all(np.array_equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_half_functions_match_reference(seed):
    """``host_keys`` (NumPy), ``host_keys_full`` (C++ or NumPy),
    ``audit_device_runs`` and ``resolve_suspects_host`` on adversarial
    keys and on random winner and suspect flags, which break every run
    invariant the audit checks."""
    rng = np.random.default_rng(seed)
    pos = adversarial_host_positions(seed=100 + seed)
    cs, scs = grid(3 * seed)
    for g, r in zip(td.host_keys(pos, cs, scs), jd.host_keys(pos, cs, scs)):
        assert np.array_equal(g.view(np.uint8), r.view(np.uint8))
    keys = td.host_keys_full(pos, cs, scs)
    for g, r in zip(keys, jd.host_keys_full(pos, cs, scs)):
        assert np.array_equal(g.view(np.uint8), r.view(np.uint8))
    cell_idx, sub_idx, dist, _ = keys
    order = np.lexsort((dist, *sub_idx.T[::-1], *cell_idx.T[::-1]))
    cell_s, sub_s, dist_s = cell_idx[order], sub_idx[order], dist[order]
    perm = order.astype(np.int32)
    for p_win, p_sus in [(0.5, 0.0), (0.3, 0.1), (0.9, 0.5)]:
        winner = rng.random(len(pos)) < p_win
        suspect = rng.random(len(pos)) < p_sus
        got = td.audit_device_runs(winner, suspect, cell_s, sub_s)
        ref = jd.audit_device_runs(winner, suspect, cell_s, sub_s)
        assert np.array_equal(got, ref) and got.sum() > suspect.sum()
        assert np.array_equal(
            td.resolve_suspects_host(perm, winner, cell_s, sub_s, dist_s,
                                     got),
            jd.resolve_suspects_host(perm, winner, cell_s, sub_s, dist_s,
                                     ref))
