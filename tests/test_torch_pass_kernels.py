"""The conversion pass's two kernels, B2 (``ops/quantize_hash.py``,
``csrc/quantize_hash.cu``: the load stage of the fused front end, whose
own cases are in tests/test_torch_front_end.py) and B3
(``ops/mark_pack.py``, ``csrc/mark_pack.cu``), and their plain versions
in ``ops/dedup.py``.

On the CPU (JAX on the CPU too, imported inside the tests):

- ``quantize_hash_reference``'s keys and distances bit-equal to the
  reference's NumPy/C++ oracle (``host_keys_full``), its hashes to the
  reference's ``_hash_cols`` of those keys (under ``jax.jit``, as
  tests/test_torch_dedup.py runs it), its keys to JAX ``hex_keys``'s and
  its sorted hash columns to JAX ``_hash_sort``'s, its distances within
  the fma-drift band of XLA:CPU's (which may contract the chain into fmas
  and, at |p| ~ 2^31, quantizes off the oracle: there only the oracle
  holds);
- ``mark_pack_reference`` on JAX's own sorted columns bit-equal to JAX
  ``dedup_pass_light`` and ``dedup_pass_resident`` (one jitted program
  returns both, so the columns are the ones the packed rows came from);
- on every shape the kernels meet: a LiDAR-like cloud, uniform points,
  one point repeated in every row (a single run of the whole bucket), a
  1/8 lattice (exact duplicates: tied distances, near-tie flags), |p| ~
  500 with hex-edge x == 0.0 rows, forced hash collisions, a resident
  mix of resident rows, extras and padding, and huge coordinates that
  saturate the i32 casts. Non-finite coordinates are held against the
  NumPy oracle's keys only: NaN bits differ between the CPU and the card;
- the wrappers' refusals (dtype, shape, device, contiguity) and that a
  CPU call launches nothing;
- B3's run spread on sorted columns built directly (``run_case``): one
  run of 1, a tile less one, a tile, a tile and one, 2^15 rows or the
  whole array among short runs and padding, a mismatch (a key change or
  a near-tie) only in the run's first, a middle or its last tile, or
  none; ``mark_pack_reference`` against a NumPy run-spread oracle;
- the owner cascade's ``_winner_and_suspect`` and the full
  ``dedup_pass`` take their flags from B3: equal to
  ``mark_pack_reference``'s bits on forced collisions and near-ties.

The ``cuda`` cases (skipped without a card) hold B3 bit-equal to its
plain version on the card over the same shapes, non-finite ones too,
at 2^15-2^22 rows and on every ``run_case``, the light and resident
passes equal to the CPU's, and one fused front end (B2 inside the sort,
``tests/test_torch_front_end.py``) and one B3 launch a pass; B3 over
200 calls of mixed lengths queued back to back on one stream, and passes
from three threads on two streams at once (as the pipelined converter
runs them), each equal to its plain result: no state leaks from one call
to the next. On the card, without JAX:
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_pass_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.core.metadata import MetadataConfig
from point_cloud_tpu_torch.models.synth import (
    PASS_SHAPES, pass_case as case, resident_case,
)
from point_cloud_tpu_torch.ops import dedup as td
from point_cloud_tpu_torch.ops import mark_pack as tmark
from point_cloud_tpu_torch.ops import quantize_hash as tquant
from point_cloud_tpu_torch.ops import sort as tsort
from point_cloud_tpu_torch.ops.sort import sort4
from point_cloud_tpu_torch.parallel import owner_cascade

I32_MAX = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores (see tests/test_torch_dedup.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KINDS = list(PASS_SHAPES)  # the shapes of models.synth.pass_case
FINITE_KINDS = [k for k in KINDS if k != "nonfinite"]


def grid(hierarchy):
    config = MetadataConfig()
    cell_size = config.cell_size(hierarchy)
    return cell_size, config.sub_cell_size(cell_size)


def torch_args(pos, valid, hierarchy, device="cpu"):
    cs, scs = grid(hierarchy)
    return td.pass_args(pos, valid, cs, scs, device)


def collide(ch, sh):
    """Forced hash collisions, as tests/test_torch_dedup.py makes them
    (``_hash_cols`` cut to its low bit): every real cell hash becomes 0
    and every slot hash 0 or 1, so two runs hold every real row."""
    real = ch != I32_MAX
    return (torch.where(real, torch.zeros_like(ch), ch),
            torch.where(real, sh & 1, sh))


# --- JAX, on the CPU ------------------------------------------------------


def jax_scalars(hierarchy):
    import jax.numpy as jnp

    cs, scs = grid(hierarchy)
    return (jnp.float32(np.float32(cs)),
            jnp.float32(np.float32(scs) / np.float32(2.0)))


def jax_front(pos, valid, cell_idx, sub_idx, hierarchy):
    """From one jitted program: JAX's keys and ``_hash_sort``'s sorted
    columns of ``pos``, and the reference's ``_hash_cols`` with the
    padding sentinels applied to the given keys."""
    import jax
    import jax.numpy as jnp

    from point_cloud_tpu.ops import dedup as jd

    def body(positions, valid, cell_idx, sub_idx, cell_size, radius):
        cols_cell = tuple(cell_idx[:, i] for i in range(3))
        cols_all = cols_cell + tuple(sub_idx[:, i] for i in range(3))
        ch = jd._hash_cols(cols_cell, jd._PRIMES_A) & np.int32(0x7FFFFFFE)
        sh = jd._hash_cols(cols_all, jd._PRIMES_B)
        return (jd.hex_keys(positions, cell_size, radius),
                (jnp.where(valid, ch, np.int32(I32_MAX)),
                 jnp.where(valid, sh, np.int32(0))),
                jd._hash_sort(positions, valid, cell_size, radius)[:4])

    out = jax.jit(body)(*(jnp.asarray(a) for a in (pos, valid, cell_idx,
                                                   sub_idx)),
                        *jax_scalars(hierarchy))
    return jax.tree_util.tree_map(np.array, out)


def jax_light(pos, valid, hierarchy, hash_cols=None):
    """JAX ``_hash_sort``'s sorted columns and ``dedup_pass_light``'s
    packed rows from one jitted program; ``hash_cols`` replaces the
    reference's ``_hash_cols`` while it traces (forced collisions)."""
    import jax
    import jax.numpy as jnp

    from point_cloud_tpu.ops import dedup as jd

    def body(positions, valid, cell_size, radius):
        return (jd._hash_sort(positions, valid, cell_size, radius)[:4],
                jd._dedup_light_body(positions, valid, cell_size, radius))

    real = jd._hash_cols
    if hash_cols is not None:
        jd._hash_cols = hash_cols
    try:
        out = jax.jit(body)(jnp.asarray(pos), jnp.asarray(valid),
                            *jax_scalars(hierarchy))
    finally:
        jd._hash_cols = real
    return jax.tree_util.tree_map(np.array, out)


QUANT_CASES = [(k, 1 << 12, h) for k, h in zip(FINITE_KINDS, (0, 3, 5, 7, 9,
                                                               2))]
QUANT_CASES += [("synth", 1 << 16, 4), ("far", 1 << 14, 12),
                ("lattice", 1 << 14, 1), ("saturate", 1 << 14, 0)]


@pytest.mark.parametrize("kind,n,hierarchy", QUANT_CASES)
def test_quantize_hash_reference_matches_jax(kind, n, hierarchy):
    from point_cloud_tpu.ops import dedup as jd

    pos, valid = case(kind, n, seed=hierarchy)
    cs, scs = grid(hierarchy)
    args = torch_args(pos, valid, hierarchy)
    ch, sh, db, arrival, cell_idx, sub_idx, dist = (
        t.numpy() for t in td.quantize_hash_reference(*args, keys=True))
    (j_cell, j_sub, j_dist), (j_ch, j_sh), j_sorted = jax_front(
        pos, valid, cell_idx, sub_idx, hierarchy)
    # keys and distances bit-exact against the reference's IEEE oracle
    # (its NumPy/C++ host_keys_full)
    h_cell, h_sub, h_dist, _ = jd.host_keys_full(pos, cs, scs)
    assert np.array_equal(cell_idx, h_cell) and np.array_equal(sub_idx, h_sub)
    assert np.array_equal(dist.view(np.int32), h_dist.view(np.int32))
    # hashes: the reference's _hash_cols of these keys, bit for bit
    assert np.array_equal(ch, j_ch) and np.array_equal(sh, j_sh)
    assert np.array_equal(db, np.where(valid, dist.view(np.int32), I32_MAX))
    assert np.array_equal(arrival, np.arange(n, dtype=np.int32))
    if kind == "saturate":
        # the case reaches the saturating casts; there XLA:CPU's jitted
        # quantization itself leaves the oracle (|y| ~ 2^31 rows land one
        # slot row over), so JAX's own keys and sort are not compared
        assert (cell_idx == I32_MAX).any() and (cell_idx == -(2**31)).any()
        assert (sub_idx == I32_MAX).any()
        return
    assert np.array_equal(cell_idx, j_cell) and np.array_equal(sub_idx, j_sub)
    # XLA:CPU may contract the distance chain into fmas, which moves a
    # slot centre by up to an ulp of |p| (e = 64 * |p|_max * 2^-24 with
    # the reference's headroom, _near_tie_mask) and the distance by up to
    # 2 sqrt(d) e + e^2: within that of JAX's, or 8 ulps
    # (tests/test_torch_dedup.py's rule, with the e^2 term rows at d ~ 0
    # need)
    ulps = np.abs(dist.view(np.int32).astype(np.int64)
                  - j_dist.view(np.int32).astype(np.int64))
    e = 64 * 2.0**-24 * np.abs(pos.astype(np.float64)).max(axis=1)
    d = dist.astype(np.float64)
    band = 2 * np.sqrt(d) * e + e * e
    assert np.all((ulps <= 8) | (np.abs(j_dist - d) <= band))
    # sorted into JAX _hash_sort's hash runs
    got = sort4(*(torch.from_numpy(c) for c in (ch, sh, db, arrival)))
    assert np.array_equal(got[0].numpy(), j_sorted[0])
    assert np.array_equal(got[1].numpy(), j_sorted[1])


LIGHT_CASES = [("synth", 1 << 14, 0), ("uniform", 1 << 12, 6),
               ("all_equal", 1 << 12, 3), ("lattice", 1 << 14, 4),
               ("far", 1 << 14, 14), ("saturate", 1 << 12, 1),
               ("collide", 1 << 14, 9)]


@pytest.mark.parametrize("kind,n,hierarchy", LIGHT_CASES)
def test_mark_pack_reference_matches_jax_light(kind, n, hierarchy):
    """B3's plain version on JAX's sorted columns equals JAX's packed rows
    bit for bit, every row."""
    shape = "uniform" if kind == "collide" else kind
    pos, valid = case(shape, n, seed=hierarchy)
    hash_cols = None
    if kind == "collide":
        from point_cloud_tpu.ops import dedup as jd

        real = jd._hash_cols

        def hash_cols(cols, primes):
            return real(cols, primes) & np.int32(1)

    cols, packed = jax_light(pos, valid, hierarchy, hash_cols)
    args = torch_args(pos, valid, hierarchy)
    got = td.mark_pack_reference(*(torch.from_numpy(c) for c in cols),
                                 args[0], *args[2:]).numpy()
    assert np.array_equal(got, packed)
    suspects = ((got >> 29) & 1).sum()
    winners = ((got >> 30) & 1).sum()
    if kind == "all_equal":  # one run, every pair a near tie
        assert winners == 1 and suspects == n
    if kind in ("collide", "lattice", "far"):
        assert suspects > 0
    if kind == "collide":
        assert suspects > valid.sum() // 2


@pytest.mark.parametrize("seed", [1, 2])
def test_mark_pack_reference_matches_jax_resident(seed):
    """The resident level: the plain gather (padding reads row 0) and B3's
    plain version on JAX's sorted columns of those rows equal JAX
    ``dedup_pass_resident``'s packed rows bit for bit."""
    import jax
    import jax.numpy as jnp

    from point_cloud_tpu.ops import dedup as jd

    n = 1 << 14
    hierarchy = 2 + seed
    resident, src, extras = resident_case(n, seed)
    positions, valid = td.resident_rows_reference(
        torch.from_numpy(resident), torch.from_numpy(src),
        torch.from_numpy(extras))
    pos, val = positions.numpy(), valid.numpy()

    def body(resident, src, extras, positions, valid, cell_size, radius):
        return (jd._hash_sort(positions, valid, cell_size, radius)[:4],
                jd._dedup_resident_body(resident, src, extras, cell_size,
                                        radius))

    cols, packed = jax.tree_util.tree_map(np.array, jax.jit(body)(
        *(jnp.asarray(a) for a in (resident, src, extras, pos, val)),
        *jax_scalars(hierarchy)))
    args = torch_args(pos, val, hierarchy)
    got = td.mark_pack_reference(*(torch.from_numpy(c) for c in cols),
                                 positions, *args[2:]).numpy()
    assert np.array_equal(got, packed)
    # the gathered rows: resident or extras, as JAX gathers them
    real = src != I32_MAX
    want = np.where((src >= 0)[:, None],
                    resident[np.where(real & (src >= 0), src, 0)],
                    extras[np.where(src < 0, ~src, 0)])
    assert np.array_equal(pos[real], want[real])
    assert np.array_equal(val, real)
    assert np.array_equal(pos[~real], np.broadcast_to(resident[0],
                                                      pos[~real].shape))
    # and the front end's gather mode on the CPU is the plain version:
    # B2's columns of the gathered rows, sorted, then the rows
    out = tquant.quantize_sort4_resident(
        torch.from_numpy(resident), torch.from_numpy(src),
        torch.from_numpy(extras), *args[2:])
    ref = sort4(*td.quantize_hash_reference(positions, valid, *args[2:]))
    assert all(torch.equal(a, b) for a, b in zip(out[:4], ref))
    assert torch.equal(out[4], positions)


@pytest.mark.parametrize("hierarchy", [0, 6])
def test_nonfinite_keys_match_numpy_oracle(hierarchy):
    """NaN and infinite coordinates: the plain B2's keys equal the NumPy/C++
    host oracle's (saturating casts, NaN -> 0), its hashes follow from
    them, and B3's plain version flags such rows like any other."""
    n = 1 << 12
    pos, valid = case("nonfinite", n, seed=hierarchy)
    cs, scs = grid(hierarchy)
    args = torch_args(pos, valid, hierarchy)
    ch, sh, db, arrival, cell_idx, sub_idx, dist = \
        td.quantize_hash_reference(*args, keys=True)
    h_cell, h_sub, h_dist, _ = td.host_keys_full(pos, cs, scs)
    assert np.array_equal(cell_idx.numpy(), h_cell)
    assert np.array_equal(sub_idx.numpy(), h_sub)
    assert np.array_equal(np.isnan(dist.numpy()), np.isnan(h_dist))
    finite = ~np.isnan(h_dist)
    assert np.array_equal(dist.numpy()[finite], h_dist[finite])
    assert np.isnan(h_dist[valid]).any()
    packed = td.mark_pack_reference(*sort4(ch, sh, db, arrival), args[0],
                                    *args[2:])
    assert torch.equal(packed, td.dedup_pass_light(*args))


# --- the wrappers on the CPU ------------------------------------------------


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    pos, valid = case("lattice", 1 << 12, seed=5)
    args = torch_args(pos, valid, 5)
    before = (tquant.launches, tmark.launches)
    got = tquant.quantize_sort4(*args, keys=True)
    ref = td.quantize_hash_reference(*args, keys=True)
    sorted_cols = sort4(*ref[:4])
    assert all(torch.equal(a, b) for a, b in zip(got, sorted_cols + ref[4:]))
    packed = tmark.mark_pack(*got[:4], args[0], *args[2:])
    assert torch.equal(packed, td.mark_pack_reference(*sorted_cols, args[0],
                                                      *args[2:]))
    assert torch.equal(packed, td.dedup_pass_light(*args))
    assert (tquant.launches, tmark.launches) == before


def _quant_args():
    pos, valid = case("uniform", 1 << 10, seed=1)
    return list(torch_args(pos, valid, 3))


def _bad_quant(kind):
    a = _quant_args()
    if kind == "dtype_positions":
        a[0] = a[0].double()
    elif kind == "dtype_valid":
        a[1] = a[1].to(torch.int32)
    elif kind == "shape_positions":
        a[0] = torch.zeros((a[0].shape[0], 4))
    elif kind == "shape_valid":
        a[1] = a[1][:-1]
    elif kind == "device":
        a[0] = a[0].to("meta")
    elif kind == "device_valid":
        a[1] = a[1].to("meta")
    elif kind == "contiguity":
        a[0] = torch.zeros((3, a[0].shape[0])).t()
    elif kind == "scalar_dtype":
        a[2] = a[2].double()
    elif kind == "empty":
        a[0], a[1] = a[0][:0], a[1][:0]
    return a


@pytest.mark.parametrize("kind", [
    "dtype_positions", "dtype_valid", "shape_positions", "shape_valid",
    "device", "device_valid", "contiguity", "scalar_dtype", "empty"])
def test_quantize_hash_refuses(kind):
    """B2's checks, which the fused front end makes before it runs (here
    with its keys asked for)."""
    with pytest.raises(ValueError):
        tquant.quantize_sort4(*_bad_quant(kind), keys=True)


@pytest.mark.parametrize("kind", ["dtype", "device", "contiguity", "shape"])
def test_quantize_hash_resident_refuses(kind):
    resident, src, extras = (torch.from_numpy(a)
                             for a in resident_case(1 << 10, seed=3))
    if kind == "dtype":
        src = src.long()
    elif kind == "device":
        extras = extras.to("meta")
    elif kind == "contiguity":
        resident = resident.t().contiguous().t()
    elif kind == "shape":
        extras = extras[:, :2].contiguous()
    cs, scs = grid(3)
    with pytest.raises(ValueError):
        tquant.quantize_sort4_resident(resident, src, extras, cs, scs / 2)


@pytest.mark.parametrize("kind", ["dtype", "length", "shape", "device",
                                  "contiguity", "positions_dtype",
                                  "positions_contiguity"])
def test_mark_pack_refuses(kind):
    a = _quant_args()
    cols = list(tquant.quantize_sort4(*a))
    pos = a[0]
    if kind == "dtype":
        cols[3] = cols[3].long()
    elif kind == "length":
        cols[1] = cols[1][:-1]
    elif kind == "shape":
        cols[0] = cols[0][:, None]
    elif kind == "device":
        cols[2] = cols[2].to("meta")
    elif kind == "contiguity":
        cols[0] = torch.stack([cols[0], cols[0]], 1)[:, 0]
    elif kind == "positions_dtype":
        pos = pos.double()
    elif kind == "positions_contiguity":
        pos = torch.zeros((3, pos.shape[0])).t()
    with pytest.raises(ValueError):
        tmark.mark_pack(*cols, pos, *a[2:])


# --- B3's run spread on sorted columns built directly ----------------------

TILE = tmark.TILE_ROWS
RUN_CELL_SIZE, RUN_RADIUS = np.float32(1.0), np.float32(0.05)
P_RUN = (0.3, 0.3, 0.3)  # every row's position...
P_KEY = (5.3, 0.3, 0.3)  # ...but a key change's: another cell
LEAD, TRAIL, PAD = TILE // 2 + 3, 700, 37  # rows around the long run


def _run_bounds(length):
    """(first row, end row, n) of the long run of ``run_case``."""
    if length == "whole":
        n = 3 * TILE + 5
        return 0, n, n
    lead = TILE if length == "aligned" else LEAD
    size = TILE if length == "aligned" else length
    return lead, lead + size, lead + size + TRAIL + PAD


def _mismatch_row(length, place):
    """The row that carries the planned mismatch, or None."""
    a, b, _ = _run_bounds(length)
    first_tile, last_tile = a // TILE, (b - 1) // TILE
    if place == "first":
        return a + 1
    if place == "last":
        return b - 2
    if place == "middle":
        return (first_tile + 1) * TILE + 10
    return None


RUN_CASES = [("n=1", "none")]
for _length in (1, TILE - 1, TILE, TILE + 1, 1 << 15, "whole", "aligned"):
    _a, _b, _ = _run_bounds(_length)
    _tiles = (_b - 1) // TILE - _a // TILE + 1
    _places = ["none"]
    if _b - _a > 2:
        _places += ["first", "last"] + (["middle"] if _tiles > 2 else [])
    RUN_CASES += [(_length, _place) for _place in _places]


def run_case(length, place, seed=0):
    """Sorted columns and positions with one long run, and the rows that
    hold a mismatch. Short runs of 1-3 rows surround it, then padding
    rows (cell hash i32::MAX); distance bits rise by 1,000 ulps a row
    (no near-tie). A planned mismatch is a near-tie (a 3-ulp step) on an
    even ``seed``, else a key change (the row's position in another
    cell: a mismatch on it and on the row after). Returns (ch, sh, db,
    perm, positions, mismatch) as NumPy arrays."""
    rng = np.random.default_rng(seed)
    if length == "n=1":
        a, b, n = 0, 1, 1
    else:
        a, b, n = _run_bounds(length)
    run_id = np.zeros(n, np.int64)
    sizes = rng.integers(1, 4, n)
    r, k = 0, 0
    while r < n:  # short runs, then the long one at [a, b)
        size = b - a if r == a else min(int(sizes[k]), (a if r < a else n) - r)
        run_id[r:r + size] = k
        r, k = r + size, k + 1
    ch = (run_id * 11 + 5).astype(np.int32)
    sh = (run_id * 7 % 5).astype(np.int32)
    db = (0x3F800000 + 1000 * np.arange(n)).astype(np.int32)
    pad = slice(n - PAD, n) if length not in ("n=1", "whole") else slice(n, n)
    ch[pad], sh[pad], db[pad] = I32_MAX, 0, I32_MAX
    perm = rng.permutation(n).astype(np.int32)
    positions = np.tile(np.float32(P_RUN), (n, 1))
    mismatch = np.zeros(n, bool)
    row = _mismatch_row(length, place) if length != "n=1" else None
    if row is not None:
        mismatch[row] = True
        if seed % 2 == 0:
            db[row] = db[row - 1] + 3
        else:
            positions[perm[row]] = P_KEY
            mismatch[row + 1] = row + 1 < b
    return ch, sh, db, perm, positions, mismatch


def spread_oracle(ch, sh, perm, mismatch):
    """NumPy: ``perm | winner << 30 | suspect << 29`` with a run's rows
    suspect where any row of the run holds a mismatch."""
    first = np.ones(len(ch), bool)
    first[1:] = (ch[1:] != ch[:-1]) | (sh[1:] != sh[:-1])
    valid = ch != I32_MAX
    run = np.cumsum(first) - 1
    hit = np.zeros(run[-1] + 1, bool)
    np.logical_or.at(hit, run, mismatch)
    return (perm | ((first & valid).astype(np.int32) << 30)
            | ((hit[run] & valid).astype(np.int32) << 29))


def run_args(case, device="cpu"):
    *cols, positions, _ = case
    return ([torch.from_numpy(c).to(device) for c in cols],
            torch.from_numpy(positions).to(device),
            td.f32_scalar(RUN_CELL_SIZE, device),
            td.f32_scalar(RUN_RADIUS, device))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("length,place", RUN_CASES)
def test_mark_pack_reference_spreads_runs(length, place, seed):
    case = run_case(length, place, seed)
    cols, positions, cs, radius = run_args(case)
    got = td.mark_pack_reference(*cols, positions, cs, radius).numpy()
    want = spread_oracle(case[0], case[1], case[3], case[5])
    assert np.array_equal(got, want)
    if place != "none":  # every row of the long run, and only those
        a, b, _ = _run_bounds(length)
        assert np.array_equal(np.nonzero((got >> 29) & 1)[0],
                              np.arange(a, b))


@pytest.mark.parametrize("kind", ["collide", "lattice"])
def test_owner_and_full_pass_flags_are_b3s(kind, monkeypatch):
    """``_winner_and_suspect`` (both owner stages) and ``dedup_pass`` take
    winner and suspect from B3: on forced collisions and on a lattice's
    near-ties they equal ``mark_pack_reference``'s unpacked bits."""
    n = 1 << 12
    pos, valid = case("uniform" if kind == "collide" else kind, n, seed=4)
    if kind == "collide":
        real = td._hash_cols
        monkeypatch.setattr(td, "_hash_cols",
                            lambda cols, primes: real(cols, primes) & 1)
    args = torch_args(pos, valid, 4)
    ch_s, sh_s, db_s, perm, *_ = td._hash_sort(*args)
    want = td.mark_pack_reference(ch_s, sh_s, db_s, perm, args[0], *args[2:])
    winner, suspect = (want >> 30) & 1 == 1, (want >> 29) & 1 == 1
    assert suspect.any() and winner.any()
    packed, w, s = owner_cascade._winner_and_suspect(
        ch_s, sh_s, db_s, perm, args[0], *args[2:])
    assert torch.equal(packed, want)
    assert torch.equal(w, winner) and torch.equal(s, suspect)
    out = td.dedup_pass(*args, td.f32_scalar(np.float32(0.5), "cpu"))
    assert torch.equal(out[0], perm)
    assert torch.equal(out[1], winner) and torch.equal(out[7], suspect)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 and B3 have no CPU mode")
    return torch.device("cuda")


CARD_LOG_N = list(range(15, 23))


def card_columns(kind, log_n, device):
    """The sorted columns B3 meets on the card: the fused front end's, or
    for ``collide`` B2's plain columns with the collision transform,
    sorted by sort4; and the pass arguments."""
    shape = "uniform" if kind == "collide" else kind
    pos, valid = case(shape, 1 << log_n, seed=log_n)
    args = torch_args(pos, valid, log_n % 8, device)
    if kind != "collide":
        return tquant.quantize_sort4(*args), args
    ch, sh, db, arrival = td.quantize_hash_reference(*args)
    ch, sh = collide(ch, sh)
    return sort4(ch, sh, db, arrival), args


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS + ["collide"])
@pytest.mark.parametrize("log_n", CARD_LOG_N)
def test_mark_pack_kernel_matches_reference_on_card(cuda_device, kind, log_n):
    cols, args = card_columns(kind, log_n, cuda_device)
    before = tmark.launches
    got = tmark.mark_pack(*cols, args[0], *args[2:])
    torch.cuda.synchronize()
    assert tmark.launches == before + 1
    ref = td.mark_pack_reference(*cols, args[0], *args[2:])
    assert torch.equal(got, ref)
    if kind == "all_equal":  # one run of every row
        assert int(((got >> 29) & 1).sum()) == 1 << log_n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FINITE_KINDS)
def test_light_pass_on_card_matches_cpu(cuda_device, kind):
    pos, valid = case(kind, 1 << 18, seed=7)
    before = (tquant.launches, tsort.launches, tmark.launches)
    got = td.dedup_pass_light(*torch_args(pos, valid, 3, cuda_device))
    torch.cuda.synchronize()
    # B2 runs inside the fused front end (quantize_sort4), then B3
    assert (tquant.launches, tsort.launches, tmark.launches) == (
        before[0] + 1, before[1], before[2] + 1)
    assert torch.equal(got.cpu(),
                       td.dedup_pass_light(*torch_args(pos, valid, 3)))


@pytest.mark.cuda
def test_resident_pass_on_card_matches_cpu(cuda_device):
    host = [torch.from_numpy(a) for a in resident_case(1 << 18, seed=11)]
    cs, scs = grid(4)
    scalars = [np.float32(cs), np.float32(scs) / np.float32(2.0)]
    got = td.dedup_pass_resident(*(t.to(cuda_device) for t in host),
                                 *scalars)
    assert torch.equal(got.cpu(), td.dedup_pass_resident(*host, *scalars))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("length,place", RUN_CASES)
def test_mark_pack_kernel_spreads_runs_on_card(cuda_device, length, place,
                                               seed):
    cols, positions, cs, radius = run_args(run_case(length, place, seed),
                                           cuda_device)
    got = tmark.mark_pack(*cols, positions, cs, radius)
    torch.cuda.synchronize()
    assert torch.equal(got, td.mark_pack_reference(*cols, positions, cs,
                                                   radius))


@pytest.mark.cuda
def test_mark_pack_kernel_back_to_back_calls(cuda_device):
    """200 calls of mixed lengths queued on one stream with no wait between
    them, each equal to its plain result: the tile counter and the status
    words carry nothing from a call to the next."""
    cases = [run_args(run_case(length, place, seed), cuda_device)
             for length, place, seed in (
                 ("n=1", "none", 0), ("whole", "middle", 1),
                 (1 << 15, "last", 0), (TILE + 1, "first", 1),
                 ("aligned", "none", 0), (1 << 15, "middle", 1))]
    cases += [card_columns("synth", 15, cuda_device),
              card_columns("all_equal", 16, cuda_device)]
    calls = []
    for cols, positions, *scalars in cases[:6]:
        calls.append((cols, positions, scalars))
    for cols, args in cases[6:]:
        calls.append((cols, args[0], args[2:]))
    want = [td.mark_pack_reference(*cols, positions, *scalars)
            for cols, positions, scalars in calls]
    torch.cuda.synchronize()
    before = tmark.launches
    got = [tmark.mark_pack(*calls[i % len(calls)][0],
                           calls[i % len(calls)][1],
                           *calls[i % len(calls)][2]) for i in range(200)]
    torch.cuda.synchronize()
    assert tmark.launches == before + 200
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(calls)]), i


@pytest.mark.cuda
def test_passes_on_two_streams_from_three_threads(cuda_device):
    """Light passes from three threads at once, two on the default stream
    (as the pipelined converter's workers share it) and one on a stream
    of its own, each equal to the CPU's packed rows."""
    import threading

    inputs = [case(kind, 1 << 16, seed=s) for s, kind in
              enumerate(("synth", "all_equal", "lattice", "uniform"))]
    want = [td.dedup_pass_light(*torch_args(p, v, 2)) for p, v in inputs]
    args = [torch_args(p, v, 2, cuda_device) for p, v in inputs]
    side = torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()  # the inputs are on the card before any stream
    start = threading.Barrier(3)
    errors = []

    def worker(index, stream):
        try:
            start.wait()
            with torch.cuda.stream(stream):
                got = [td.dedup_pass_light(*args[(index + j) % len(args)])
                       for j in range(24)]
                stream.synchronize()
            for j, g in enumerate(got):
                if not torch.equal(g.cpu(), want[(index + j) % len(args)]):
                    errors.append((index, j))
        except Exception as exc:  # reported below, in the test's thread
            errors.append((index, repr(exc)))

    default = torch.cuda.default_stream(cuda_device)
    threads = [threading.Thread(target=worker, args=(i, st)) for i, st in
               enumerate((default, default, side))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
