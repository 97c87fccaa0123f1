"""The conversion pass's fused front end: B2 as the load stage of sort4's
tile kernel (``ops/quantize_hash.py`` ``quantize_sort4`` and
``quantize_sort4_resident``, ``csrc/quantize_hash.cu`` ``quantize_tile``),
and the division helper of ``csrc/hex_keys.cuh``.

On the CPU (JAX on the CPU too, imported inside the tests):

- the fused wrappers' sorted columns, in light, keys and resident modes,
  bit-equal to the reference's columns: its NumPy/C++ keys
  (``host_keys_full``), its ``_hash_cols`` of them (under ``jax.jit``),
  the padding sentinels, sorted by ``np.lexsort``; the sorted hash
  columns also equal JAX ``_hash_sort``'s own (whose distances XLA:CPU
  may fma-contract: there only the oracle is IEEE), the keys mode's
  unsorted keys equal the oracle's, the resident mode's gathered rows
  the reference's gather;
- the light and resident passes through the fused route bit-equal to
  JAX ``_dedup_light_body`` / ``_dedup_resident_body`` run on those
  columns (its ``_hash_sort`` handed the oracle's columns while it
  traces), on ``test_torch_pass_kernels.py``'s ``LIGHT_CASES``;
- the wrappers' refusals (dtype, shape, device, contiguity) and that a
  CPU call launches nothing;
- the division helper's algorithm in exact rational arithmetic: for
  every divisor of MetadataConfig's hierarchies 0-7, divisors at both
  ends of a binade's significands and random ones (scaled and negated),
  and thousands of numerators each (random bit patterns, quotients near
  a rounding midpoint, every class the range check sends to
  ``__fdiv_rn``), the reciprocal once and the quotient with one
  correction give ``np.float32(a) / np.float32(b)``; its constants are
  read from ``hex_keys.cuh``.

The ``cuda`` cases (skipped without a card) hold the fused kernel
bit-equal to its plain version at every ``CARD_LOG_N`` and shape in
light, keys and resident modes (one fused launch a call, counted by
length, and not as a ``sort4`` call), the division helper against
``__fdiv_rn`` for all 2^32 numerator bit patterns and every divisor of
hierarchies 0-7, and for all 2^46 significand pairs (which by scaling
and sign stand for every operand in its range), and fused calls from
three threads on two streams. On the card, without JAX:
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_front_end.py -m cuda``.
"""

import random
import re
from fractions import Fraction
from pathlib import Path

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

I32_MAX = 2**31 - 1
HEX_KEYS = (Path(__file__).resolve().parent.parent / "point_cloud_tpu_torch"
            / "csrc" / "hex_keys.cuh")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores (see tests/test_torch_dedup.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KINDS = list(PASS_SHAPES)
FINITE_KINDS = [k for k in KINDS if k != "nonfinite"]


def grid(hierarchy):
    config = MetadataConfig()
    cell_size = config.cell_size(hierarchy)
    return cell_size, config.sub_cell_size(cell_size)


def torch_args(pos, valid, hierarchy, device="cpu"):
    cs, scs = grid(hierarchy)
    return td.pass_args(pos, valid, cs, scs, device)


def jax_scalars(hierarchy):
    import jax.numpy as jnp

    cs, scs = grid(hierarchy)
    return (jnp.float32(np.float32(cs)),
            jnp.float32(np.float32(scs) / np.float32(2.0)))


def low_bit_hashes(real):
    """Forced hash collisions (tests/test_torch_dedup.py's): ``_hash_cols``
    cut to its low bit."""
    return lambda cols, primes: real(cols, primes) & np.int32(1)


def gather_rows(resident, src, extras):
    """The reference's gather of a resident level (dedup.py:428-452) in
    NumPy: padding (i32::MAX) reads resident row 0."""
    real = src != I32_MAX
    rows = np.where((src >= 0)[:, None],
                    resident[np.where(real & (src >= 0), src, 0)],
                    extras[np.where(src < 0, ~src, 0)])
    return rows.astype(np.float32), real


def oracle(pos, valid, hierarchy, collide=False):
    """The reference's sort columns of ``pos``: ``host_keys_full``'s keys
    and distances, the reference's ``_hash_cols`` of those keys under
    ``jax.jit`` with the padding sentinels, ``np.lexsort``'s order.
    Returns the sorted columns, the keys (cell_idx, sub_idx, dist) and
    JAX ``_hash_sort``'s own sorted columns."""
    import jax
    import jax.numpy as jnp

    from point_cloud_tpu.ops import dedup as jd

    cs, scs = grid(hierarchy)
    cell_idx, sub_idx, dist, _ = jd.host_keys_full(pos, cs, scs)

    def body(positions, valid, cell_idx, sub_idx, cell_size, radius):
        cols_cell = tuple(cell_idx[:, i] for i in range(3))
        cols_all = cols_cell + tuple(sub_idx[:, i] for i in range(3))
        ch = jd._hash_cols(cols_cell, jd._PRIMES_A) & np.int32(0x7FFFFFFE)
        sh = jd._hash_cols(cols_all, jd._PRIMES_B)
        return ((jnp.where(valid, ch, np.int32(I32_MAX)),
                 jnp.where(valid, sh, np.int32(0))),
                jd._hash_sort(positions, valid, cell_size, radius)[:4])

    real = jd._hash_cols
    if collide:
        jd._hash_cols = low_bit_hashes(real)
    try:
        (ch, sh), j_sorted = jax.tree_util.tree_map(np.array, jax.jit(body)(
            *(jnp.asarray(a) for a in (pos, valid, cell_idx, sub_idx)),
            *jax_scalars(hierarchy)))
    finally:
        jd._hash_cols = real
    db = np.where(valid, dist.view(np.int32), I32_MAX).astype(np.int32)
    arrival = np.arange(len(pos), dtype=np.int32)
    order = np.lexsort((arrival, db, sh, ch))
    cols = tuple(c[order] for c in (ch, sh, db, arrival))
    return cols, (cell_idx, sub_idx, dist), j_sorted


def assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


QUANT_CASES = [(k, 1 << 12, h) for k, h in zip(FINITE_KINDS, (0, 3, 5, 7, 9,
                                                               2))]
QUANT_CASES += [("synth", 1 << 16, 4), ("far", 1 << 14, 12),
                ("lattice", 1 << 14, 1), ("saturate", 1 << 14, 0)]
RESIDENT_CASES = [("resident", 1 << 12, 2), ("resident", 1 << 14, 5),
                  ("resident", 1 << 16, 0)]
FRONT_CASES = ([("light", *c) for c in QUANT_CASES]
               + [("keys", *c) for c in QUANT_CASES]
               + [("resident", *c) for c in RESIDENT_CASES])


@pytest.mark.parametrize("mode,kind,n,hierarchy", FRONT_CASES)
def test_quantize_sort4_matches_reference(mode, kind, n, hierarchy):
    """The fused wrappers on the CPU: the reference's sorted columns, bit
    for bit, in every mode."""
    if mode == "resident":
        resident, src, extras = resident_case(n, seed=hierarchy)
        pos, valid = gather_rows(resident, src, extras)
        args = torch_args(pos, valid, hierarchy)
        got = tquant.quantize_sort4_resident(
            *(torch.from_numpy(a) for a in (resident, src, extras)),
            *args[2:])
        assert_bits(got[4], pos)
    else:
        pos, valid = case(kind, n, seed=hierarchy)
        args = torch_args(pos, valid, hierarchy)
        got = tquant.quantize_sort4(*args, keys=mode == "keys")
    cols, keys, j_sorted = oracle(pos, valid, hierarchy)
    assert len(got) == {"light": 4, "keys": 7, "resident": 5}[mode]
    for g, want in zip(got[:4], cols):
        assert_bits(g, want)
    if mode == "keys":
        for g, want in zip(got[4:], keys):
            assert_bits(g, want)
    # the sorted hash runs are JAX _hash_sort's too (its quantization
    # leaves the oracle only where the casts saturate)
    if kind != "saturate":
        assert np.array_equal(cols[0], j_sorted[0])
        assert np.array_equal(cols[1], j_sorted[1])
    # and the composition the fused call replaces, on the CPU
    ref = (td.quantize_sort4_resident_reference(
        *(torch.from_numpy(a) for a in (resident, src, extras)), *args[2:])
        if mode == "resident" else
        td.quantize_sort4_reference(*args, keys=mode == "keys"))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


LIGHT_CASES = [("synth", 1 << 14, 0), ("uniform", 1 << 12, 6),
               ("all_equal", 1 << 12, 3), ("lattice", 1 << 14, 4),
               ("far", 1 << 14, 14), ("saturate", 1 << 12, 1),
               ("collide", 1 << 14, 9)]
PASS_CASES = ([("light", *c) for c in LIGHT_CASES]
              + [("resident", "resident", 1 << 14, s) for s in (1, 2)])


def jax_packed_on(cols, hierarchy, body, *inputs):
    """JAX ``_dedup_light_body`` (or ``_dedup_resident_body``) of
    ``inputs`` with its ``_hash_sort`` handed the sorted columns ``cols``
    while it traces: the reference's marking, audit and packing of
    them."""
    import jax
    import jax.numpy as jnp

    from point_cloud_tpu.ops import dedup as jd

    def run(*args):  # a fresh function: jit's trace cache cannot reuse
        return body(*args)  # another case's columns

    real = jd._hash_sort
    jd._hash_sort = lambda *a, **k: (*(jnp.asarray(c) for c in cols),
                                     None, None, None)
    try:
        return np.asarray(jax.jit(run)(*(jnp.asarray(a) for a in inputs),
                                       *jax_scalars(hierarchy)))
    finally:
        jd._hash_sort = real


@pytest.mark.parametrize("mode,kind,n,hierarchy", PASS_CASES)
def test_passes_through_fused_front_end_match_jax(mode, kind, n, hierarchy,
                                                  monkeypatch):
    """``dedup_pass_light`` and ``dedup_pass_resident`` on the CPU, now
    through ``quantize_sort4``: JAX's packed rows of the reference's
    sorted columns, every row."""
    from point_cloud_tpu.ops import dedup as jd

    collide = kind == "collide"
    if collide:
        monkeypatch.setattr(td, "_hash_cols", low_bit_hashes(td._hash_cols))
    if mode == "resident":
        resident, src, extras = resident_case(n, seed=hierarchy)
        pos, valid = gather_rows(resident, src, extras)
        cols = oracle(pos, valid, hierarchy)[0]
        want = jax_packed_on(cols, hierarchy, jd._dedup_resident_body,
                             resident, src, extras)
        cs, scs = grid(hierarchy)
        got = td.dedup_pass_resident(
            *(torch.from_numpy(a) for a in (resident, src, extras)),
            np.float32(cs), np.float32(scs) / np.float32(2.0))
    else:
        pos, valid = case("uniform" if collide else kind, n, seed=hierarchy)
        cols = oracle(pos, valid, hierarchy, collide=collide)[0]
        want = jax_packed_on(cols, hierarchy, jd._dedup_light_body, pos,
                             valid)
        got = td.dedup_pass_light(*torch_args(pos, valid, hierarchy))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy() & ((1 << 29) - 1), cols[3])
    if kind in ("collide", "lattice", "far"):
        assert ((want >> 29) & 1).any()


# --- the wrappers on the CPU ------------------------------------------------


def test_cpu_fused_wrappers_launch_nothing():
    pos, valid = case("lattice", 1 << 12, seed=5)
    args = torch_args(pos, valid, 5)
    before = (tquant.launches, tsort.launches, tmark.launches)
    got = tquant.quantize_sort4(*args, keys=True)
    want = td.quantize_hash_reference(*args, keys=True)
    assert all(torch.equal(g, w) for g, w in zip(
        got, tsort.sort4(*want[:4]) + want[4:]))
    td.dedup_pass_light(*args)
    td.dedup_pass(*args, td.f32_scalar(np.float32(0.5), "cpu"))
    resident, src, extras = (torch.from_numpy(a)
                             for a in resident_case(1 << 12, seed=1))
    td.dedup_pass_resident(resident, src, extras, *args[2:])
    assert (tquant.launches, tsort.launches, tmark.launches) == before


def _bad_direct(kind):
    pos, valid = case("uniform", 1 << 10, seed=1)
    a = list(torch_args(pos, valid, 3))
    if kind == "dtype":
        a[0] = a[0].double()
    elif kind == "dtype_valid":
        a[1] = a[1].to(torch.uint8)
    elif kind == "shape":
        a[0] = torch.zeros((a[0].shape[0], 2))
    elif kind == "shape_valid":
        a[1] = a[1][:-1]
    elif kind == "device":
        a[0] = a[0].to("meta")
    elif kind == "device_valid":
        a[1] = a[1].to("meta")
    elif kind == "contiguity":
        a[0] = torch.zeros((3, a[0].shape[0])).t()
    elif kind == "scalar":
        a[3] = torch.ones(2)
    return a


@pytest.mark.parametrize("kind", [
    "dtype", "dtype_valid", "shape", "shape_valid", "device", "device_valid",
    "contiguity", "scalar"])
def test_quantize_sort4_refuses(kind):
    with pytest.raises(ValueError):
        tquant.quantize_sort4(*_bad_direct(kind))


@pytest.mark.parametrize("kind", ["dtype", "device", "contiguity", "shape",
                                  "empty"])
def test_quantize_sort4_resident_refuses(kind):
    resident, src, extras = (torch.from_numpy(a)
                             for a in resident_case(1 << 10, seed=3))
    if kind == "dtype":
        resident = resident.double()
    elif kind == "device":
        src = src.to("meta")
    elif kind == "contiguity":
        extras = torch.zeros((3, extras.shape[0])).t()
    elif kind == "shape":
        src = src[:, None]
    elif kind == "empty":
        extras = extras[:0]
    cs, scs = grid(3)
    with pytest.raises(ValueError):
        tquant.quantize_sort4_resident(resident, src, extras, cs, scs / 2)


def test_division_check_runs_only_on_the_card():
    with pytest.raises(ValueError):
        tquant.division_mismatches([1000.0], [5.0], device="cpu")
    with pytest.raises(ValueError):
        tquant.division_sweep(count=4, device="cpu")


# --- the division helper, in exact rational arithmetic ----------------------


def header_constant(name):
    """An integer constant of hex_keys.cuh (``constexpr unsigned NAME =
    expression;``, the expression digits and minus signs)."""
    m = re.search(rf"constexpr unsigned {name} = ([0-9x\- ]+)u?;",
                  HEX_KEYS.read_text())
    assert m, name
    return sum(int(t, 0) * s for s, t in zip(
        [1] + [-1] * 8, m.group(1).replace(" ", "").split("-")))


def rn32(x):
    """The nearest f32 to the rational ``x`` (ties to even), as a
    Fraction; None past the largest finite f32."""
    if x == 0:
        return Fraction(0)
    m = abs(x)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1
    e = max(e, -126)  # subnormals keep the ulp of 2^-126
    ulp = Fraction(2) ** (e - 23)
    k = m / ulp
    q, rem = divmod(k.numerator, k.denominator)
    if 2 * rem > k.denominator or (2 * rem == k.denominator and q % 2):
        q += 1
    v = q * ulp
    if v >= Fraction(2) ** 128:
        return None
    return v if x > 0 else -v


def in_range(x, lo, span):
    return ((int(np.float32(x).view(np.uint32)) >> 23) & 0xFF) - lo in \
        range(span)


def helper_quotient(a, b, lo, span):
    """hex_keys.cuh's division, modelled exactly: for a divisor and a
    numerator in its range, the quotient of the reciprocal taken once
    and one correction, each fma rounded once (the remainder is not
    always exact: q0 may be more than an ulp off); a zero numerator
    times the reciprocal; anything else the IEEE quotient (the row's
    second pass, with ``__fdiv_rn``)."""
    if in_range(b, lo, span) and (a == 0 or in_range(a, lo, span)):
        A, B = Fraction(float(a)), Fraction(float(b))
        y = rn32(1 / B)
        if a == 0:  # +-0 times y: the IEEE sign
            return np.float32(a) * np.float32(float(y))
        q0 = rn32(A * y)
        r = rn32(A - B * q0)
        return np.float32(float(rn32(q0 + r * y)))
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        return np.float32(a) / np.float32(b)


def kernel_divisors(hierarchy):
    """The five divisors a kernel divides by at ``hierarchy``, rounded as
    ``make_grid`` rounds them."""
    cs, scs = grid(hierarchy)
    radius = np.float32(scs) / np.float32(2.0)
    sqrt3 = np.float32(1.73205080757)
    return [np.float32(cs), np.float32(radius * sqrt3),
            np.float32(-radius * sqrt3), radius, np.float32(3.0)]


def numerators(b, rng, lo, span):
    """Random f32 bit patterns in the helper's range, numerators whose
    quotient lies within one part in 2^40 of a rounding midpoint, and one
    of each class the range sends to ``__fdiv_rn``."""
    out = []
    while len(out) < 3000:
        a = np.uint32(rng.getrandbits(32)).view(np.float32)
        if in_range(a, lo, span):
            out.append(a)
    B = Fraction(float(b))
    for _ in range(1000):
        mant = rng.getrandbits(23) | (1 << 23)
        mid = Fraction(2 * mant + 1, 1 << 24) * Fraction(2) ** rng.randint(
            -40, 40)
        out.append(np.float32(float(rn32(B * mid))))
    f32 = np.finfo(np.float32)
    out += [np.float32(v) for v in (
        0.0, -0.0, f32.smallest_subnormal, -f32.smallest_subnormal,
        f32.tiny, -f32.tiny, 2.0**-126 * 1.5, 2.0**-61, 2.0**-60,
        2.0**61, 2.0**61 * 1.5, 2.0**126, -(2.0**127), f32.max, np.inf,
        -np.inf, np.nan)]
    return out


@pytest.mark.parametrize("hierarchy", range(8))
def test_division_helper_is_ieee_in_exact_arithmetic(hierarchy):
    lo, span = header_constant("kDivLo"), header_constant("kDivSpan")
    assert (lo, span) == (67, 121)  # |x| in [2^-60, 2^61)
    # the helper's fixed divisor 3 carries RN(1/3) as a literal
    literal = re.search(r"\{3\.0f, (0x[0-9a-fp.\-]+)f\}",
                        HEX_KEYS.read_text()).group(1)
    assert Fraction(float.fromhex(literal)) == rn32(Fraction(1, 3))
    rng = random.Random(hierarchy)
    for b in kernel_divisors(hierarchy):
        assert in_range(b, lo, span)
        for a in numerators(b, rng, lo, span):
            got = helper_quotient(a, b, lo, span)
            with np.errstate(over="ignore", under="ignore",
                             invalid="ignore"):
                want = np.float32(a) / np.float32(b)
            assert got.view(np.int32) == want.view(np.int32) or (
                np.isnan(got) and np.isnan(want)), (a, b)


# divisor significands the default config does not give: the ends of
# [1, 2), where RN(1/b) is farthest from 1/b in ulps of the quotient, and
# random ones; each scaled into the helper's range and negated once
EDGE_SIGNIFICANDS = [0x7FFFFF, 0x7FFFFE, 0x7FFF00, 0x400000, 0x3FFFFF,
                     0x000001, 0x000002, 0x0000FF]


@pytest.mark.parametrize("which", ["edges", "random"])
def test_division_helper_is_ieee_on_any_divisor(which):
    lo, span = header_constant("kDivLo"), header_constant("kDivSpan")
    rng = random.Random(which)
    mants = (EDGE_SIGNIFICANDS if which == "edges"
             else [rng.getrandbits(23) for _ in range(8)])
    for j, m in enumerate(mants):
        exponent = rng.randint(-60, 60)
        b = np.uint32(((exponent + 127) << 23) | m).view(np.float32)
        b = -b if j % 2 else b
        assert in_range(b, lo, span)
        for a in numerators(b, rng, lo, span):
            got = helper_quotient(a, b, lo, span)
            with np.errstate(over="ignore", under="ignore",
                             invalid="ignore"):
                want = np.float32(a) / np.float32(b)
            assert got.view(np.int32) == want.view(np.int32) or (
                np.isnan(got) and np.isnan(want)), (a, b)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused front end has no CPU mode")
    return torch.device("cuda")


CARD_LOG_N = list(range(15, 23))


def card_fused(mode, kind, log_n, device):
    """(fused call, plain call) of one card case."""
    n = 1 << log_n
    if mode == "resident":
        inputs = [torch.from_numpy(a).to(device)
                  for a in resident_case(n, seed=log_n)]
        cs, scs = grid(log_n % 8)
        scalars = td.pass_args(np.zeros((1, 3), np.float32), np.ones(1, bool),
                               cs, scs, device)[2:]
        return (lambda: tquant.quantize_sort4_resident(*inputs, *scalars),
                lambda: td.quantize_sort4_resident_reference(*inputs,
                                                             *scalars))
    args = torch_args(*case(kind, n, seed=log_n), log_n % 8, device)
    keys = mode == "keys"
    return (lambda: tquant.quantize_sort4(*args, keys=keys),
            lambda: td.quantize_sort4_reference(*args, keys=keys))


CARD_CASES = ([("light", k) for k in KINDS] + [("keys", k) for k in KINDS]
              + [("resident", "resident")])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kind", CARD_CASES)
@pytest.mark.parametrize("log_n", CARD_LOG_N)
def test_quantize_sort4_kernel_matches_reference_on_card(cuda_device, mode,
                                                         kind, log_n):
    fused, plain = card_fused(mode, kind, log_n, cuda_device)
    before = (tquant.launches, tquant.launches_by_n.get(1 << log_n, 0),
              tquant.gather_launches_by_n.get(1 << log_n, 0), tsort.launches)
    got = fused()
    torch.cuda.synchronize()
    gather = mode == "resident"
    assert (tquant.launches, tquant.launches_by_n[1 << log_n],
            tquant.gather_launches_by_n.get(1 << log_n, 0),
            tsort.launches) == (before[0] + 1, before[1] + 1,
                                before[2] + gather, before[3])
    want = plain()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_division_helper_matches_fdiv_rn_on_card(cuda_device):
    """Every f32 numerator bit pattern over the five divisors of each of
    hierarchies 0-7: the helper's quotient has __fdiv_rn's bits."""
    pairs = [grid(h) for h in range(8)]
    cell_sizes = [float(np.float32(cs)) for cs, _ in pairs]
    radii = [float(np.float32(scs) / np.float32(2.0)) for _, scs in pairs]
    bad, first, taken = tquant.division_mismatches(cell_sizes, radii,
                                                   cuda_device)
    assert int(bad.sum()) == 0, (bad, first)
    assert bool((first == -1).all())
    # the fast path takes every numerator in [2^-60, 2^61) and +-0
    assert bool((taken == 121 * 2**24 + 2).all()), taken


@pytest.mark.cuda
def test_division_helper_matches_fdiv_rn_on_every_significand_pair(
        cuda_device):
    """All 2^46 (numerator, divisor) significand pairs: the helper's
    quotient has __fdiv_rn's bits, so it does for every divisor and every
    numerator in its range, not only the default config's."""
    assert tquant.division_sweep(device=cuda_device) == (0, None)


@pytest.mark.cuda
def test_fused_front_end_on_two_streams_from_three_threads(cuda_device):
    """Fused calls of every mode from three threads at once, two on the
    default stream and one on a stream of its own, each equal to its
    plain result."""
    import threading

    calls = [card_fused(mode, kind, 16, cuda_device) for mode, kind in (
        ("light", "synth"), ("keys", "lattice"), ("resident", "resident"),
        ("light", "all_equal"))]
    want = [plain() for _, plain in calls]
    side = torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()  # the inputs are on the card before any stream
    start = threading.Barrier(3)
    errors = []

    def worker(index, stream):
        try:
            start.wait()
            with torch.cuda.stream(stream):
                got = [calls[(index + j) % len(calls)][0]()
                       for j in range(24)]
                stream.synchronize()
            for j, g in enumerate(got):
                w = want[(index + j) % len(calls)]
                if not all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(g, w)):
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
