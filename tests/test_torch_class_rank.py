"""K5, the frame's class ranking (point_cloud_tpu_torch/render/splat.py
``class_rank``), against the reference's functions on identical inputs.

- ``compact_classes`` (its plain version on the CPU) equals JAX's
  ``compact_classes`` of the stacked masks ``rung == c`` exactly: ``perm``
  with its 2N pad, ``counts`` and ``offsets``, at C = 1, 13, 130 and
  N = 3, 1000, 2^12, on random rungs, rows of no class only and one class
  holding every row; ``dest`` is each row's slot in JAX's ``perm``.
- ``compact_perm`` equals the index JAX's ``compact_rows`` gathers by (its
  ``point_id`` the row iota), at caps 0, N/3 and N.
- ``budget_table``'s rankings equal JAX's: the rungs' ``compact_classes``
  and the footprint raster's ``compact_rows`` of the spill mask that the
  ranks of the reference's budget arm (splat.py:797-803) give.
- The wrapper's checks on either device, and a stable-sort oracle equal to
  the plain version (the card's sweep uses it where the plain version's
  (C+1) x N one-hot does not fit).

The ``cuda`` cases hold K5 against its plain version on the card (every
output, pad and ``dest`` included) over N = 3 .. 2^22, C = 1 .. 9000,
caps 0, 1, N/3 and N and the edge shapes; here they skip. On the card,
without JAX: ``PCT_TEST_PLATFORM=gpu python -m pytest
tests/test_torch_class_rank.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.render import splat as tsplat

SIZES = (3, 1000, 1 << 12)
CLASSES = (1, 13, 130)
SHAPES = ("random", "none", "one_class")
# the plain version's (C+1) x N one-hot on the card up to this many slots;
# past it the stable-sort oracle
PLAIN_SLOTS = 1 << 27


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the workers
    share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_splat():
    from point_cloud_tpu.render import splat

    return splat


def make_rung(shape: str, n_classes: int, n: int, seed: int) -> np.ndarray:
    """(n,) i32 classes in [-1, C): ``random`` (about one row in five of no
    class, the rest skewed toward class 0 as K1's rungs are), ``none``
    (every row -1), ``one_class`` (every row in the last class)."""
    rng = np.random.default_rng(seed)
    if shape == "none":
        return np.full(n, -1, np.int32)
    if shape == "one_class":
        return np.full(n, n_classes - 1, np.int32)
    skew = np.minimum(rng.geometric(0.35, n) - 1, n_classes - 1)
    rung = np.where(rng.random(n) < 0.8, skew,
                    rng.integers(0, n_classes, n))
    return np.where(rng.random(n) < 0.2, -1, rung).astype(np.int32)


def rank_oracle(rung: np.ndarray, n_classes: int):
    """(perm, counts, offsets, dest) of a stable class ranking by NumPy's
    stable argsort, independent of the port's code."""
    n = rung.shape[0]
    cls = np.where((rung >= 0) & (rung < n_classes), rung, n_classes)
    order = np.argsort(cls, kind="stable")
    counts = np.bincount(cls, minlength=n_classes + 1)[:n_classes]
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    kept = int(counts.sum())
    perm = np.zeros(2 * n, np.int32)
    perm[:kept] = order[:kept]
    dest = np.full(n, 2 * n, np.int64)
    dest[order[:kept]] = np.arange(kept)
    return (perm, counts.astype(np.int32), offsets.astype(np.int32),
            dest.astype(np.int32))


def jax_compact_rows_index(keep: np.ndarray, out_size: int):
    """The rows JAX's ``compact_rows`` gathers (its ``point_id`` the row
    iota) and its valid count."""
    import jax.numpy as jnp

    n = keep.shape[0]
    out = jax_splat().compact_rows(
        jnp.asarray(keep), jnp.zeros((n, 4), jnp.float32),
        jnp.zeros((n, 3), jnp.float32), jnp.zeros(n, jnp.float32),
        jnp.arange(n, dtype=jnp.int32), out_size)
    return np.asarray(out[3]), int(np.asarray(out[4]).sum())


def jax_compact_classes(rung: np.ndarray, n_classes: int):
    import jax.numpy as jnp

    masks = np.stack([rung == c for c in range(n_classes)])
    return [np.asarray(x) for x in jax_splat().compact_classes(
        jnp.asarray(masks))]


# --- the plain versions against JAX ----------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_compact_classes_equals_jax(n_classes, n, shape):
    rung = make_rung(shape, n_classes, n, seed=n * 131 + n_classes)
    perm, counts, offsets, dest = (x.numpy() for x in tsplat.class_rank(
        torch.from_numpy(rung), n_classes, with_dest=True))
    ref_perm, ref_counts, ref_offsets = jax_compact_classes(rung, n_classes)
    assert perm.dtype == counts.dtype == offsets.dtype == np.int32
    assert np.array_equal(perm, ref_perm)  # the 2N pad too
    assert np.array_equal(counts, ref_counts)
    assert np.array_equal(offsets, ref_offsets)
    got = tsplat.compact_classes(torch.from_numpy(rung), n_classes)
    for g, r in zip(got, (ref_perm, ref_counts, ref_offsets)):
        assert np.array_equal(g.numpy(), r)
    # dest: each classed row's slot in JAX's perm, 2N for no class
    kept = rung >= 0
    assert np.array_equal(ref_perm[dest[kept]], np.flatnonzero(kept))
    assert (dest[~kept] == 2 * n).all()


@pytest.mark.parametrize("cap", ("zero", "third", "all"))
@pytest.mark.parametrize("n", SIZES)
def test_compact_perm_equals_jax_compact_rows(n, cap):
    rng = np.random.default_rng(n + len(cap))
    keep = rng.random(n) < 0.6
    out_size = {"zero": 0, "third": n // 3, "all": n}[cap]
    perm, count = tsplat.compact_perm(torch.from_numpy(keep), out_size)
    ref_perm, ref_valid = jax_compact_rows_index(keep, out_size)
    assert perm.dtype == count.dtype == torch.int32
    assert np.array_equal(perm.numpy(), ref_perm)
    assert count.tolist() == [int(keep.sum())]  # uncapped
    assert min(int(keep.sum()), out_size) == ref_valid


BUDGET_CASES = {
    # name: (rung seed, rows, rungs, footprint rung, budgets, out_size)
    "spill": (1, 3000, (3, 5, 9, 17), 1, (40, None, 500, 60), 2500),
    "no_spill": (2, 1000, (5, 9, 17), 0, (None, 2000, 2000), 1000),
    "zero_budgets": (3, 1000, (2, 5, 9), 1, (0, None, 0), 1000),
    "clip": (4, 2000, (5, 9, 17, 33), 0, (None, 30, 10, 5), 300),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_budget_table_equals_jax_spill(case):
    """``budget_table``'s perm: the rungs' ranking as JAX's
    ``compact_classes``, then the footprint raster's slots as JAX's
    ``compact_rows`` of the spill mask of splat.py:797-803; its counts
    the rungs' and the spill's."""
    import jax.numpy as jnp

    seed, n, rungs, fp_i, budgets, out_size = BUDGET_CASES[case]
    rung = make_rung("random", len(rungs), n, seed)
    _, perm, counts, offsets, rung_counts = tsplat.budget_table(
        torch.from_numpy(rung), rungs, fp_i, budgets, out_size)
    masks = [jnp.asarray(rung == j) for j in range(len(rungs))]
    fp_mask = masks[fp_i]
    for j, m in enumerate(masks):
        if j != fp_i:
            rank = jnp.cumsum(m.astype(jnp.int32)) - 1
            fp_mask = fp_mask | (m & (rank >= budgets[j]))
    fp_mask = np.asarray(fp_mask)
    ref_rung_perm, ref_counts, ref_offsets = jax_compact_classes(
        rung, len(rungs))
    ref_fp_perm, _ = jax_compact_rows_index(fp_mask, out_size)
    perm = perm.numpy()
    assert np.array_equal(perm[: 2 * n], ref_rung_perm)
    assert np.array_equal(perm[2 * n:], ref_fp_perm)
    assert np.array_equal(rung_counts.numpy(), ref_counts)
    assert counts.tolist() == ref_counts.tolist() + [int(fp_mask.sum())]
    assert offsets.tolist() == ref_offsets.tolist() + [2 * n]
    if case == "spill":
        assert fp_mask.sum() > (rung == fp_i).sum()  # rows did spill


# --- the oracle and the wrapper's checks ------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_classes", (1, 2, 13, 130))
def test_sort_oracle_equals_plain(n_classes, shape):
    rung = make_rung(shape, n_classes, 2000, seed=n_classes)
    got = tsplat.class_rank_reference(torch.from_numpy(rung), n_classes,
                                      with_dest=True)
    for g, r in zip(got, rank_oracle(rung, n_classes)):
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("bad", ("i64_rung", "two_dims", "strided", "c0",
                                 "cap_two_classes", "cap_dest",
                                 "cap_negative", "cap_i32", "mask_uncapped"))
def test_class_rank_refuses(bad):
    rung = torch.zeros(64, dtype=torch.int32)
    keep = torch.ones(64, dtype=torch.bool)
    call = {
        "i64_rung": lambda: tsplat.class_rank(rung.long(), 3),
        "two_dims": lambda: tsplat.class_rank(rung.reshape(8, 8), 3),
        "strided": lambda: tsplat.class_rank(rung[::2], 3),
        "c0": lambda: tsplat.class_rank(rung, 0),
        "cap_two_classes": lambda: tsplat.class_rank(keep, 2, out_size=8),
        "cap_dest": lambda: tsplat.class_rank(keep, 1, out_size=8,
                                              with_dest=True),
        "cap_negative": lambda: tsplat.class_rank(keep, 1, out_size=-1),
        "cap_i32": lambda: tsplat.class_rank(rung, 1, out_size=8),
        "mask_uncapped": lambda: tsplat.class_rank(keep, 1),
    }[bad]
    with pytest.raises(ValueError):
        call()


def test_class_rank_counts_no_cpu_launch():
    before = tsplat.rank_launches
    tsplat.compact_classes(torch.zeros(10, dtype=torch.int32), 2)
    tsplat.compact_perm(torch.ones(10, dtype=torch.bool), 4)
    assert tsplat.rank_launches == before


# --- K5 on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU mode")
    return torch.device("cuda")


def assert_kernel_equals(rung: np.ndarray, n_classes: int, device,
                         out_size=None):
    """K5 on the card against its plain version (or, past PLAIN_SLOTS, the
    stable-sort oracle): every output, bit for bit."""
    n = rung.shape[0]
    if out_size is None:
        t = torch.from_numpy(rung).to(device)
        before = tsplat.rank_launches
        got = tsplat.class_rank(t, n_classes, with_dest=True)
        assert tsplat.rank_launches == before + 1
        if (n_classes + 1) * n <= PLAIN_SLOTS:
            ref = [x.cpu().numpy() for x in tsplat.class_rank_reference(
                t, n_classes, with_dest=True)]
        else:
            ref = rank_oracle(rung, n_classes)
    else:
        keep = torch.from_numpy(rung == 0).to(device)
        got = tsplat.class_rank(keep, 1, out_size=out_size)[:3]
        ref = [x.cpu().numpy() for x in tsplat.class_rank_reference(
            keep, 1, out_size=out_size)[:3]]
    torch.cuda.synchronize()
    for name, g, r in zip(("perm", "counts", "offsets", "dest"), got, ref):
        assert np.array_equal(g.cpu().numpy(), r), name


@pytest.mark.cuda
class TestKernel:
    @pytest.mark.parametrize("n_classes", (1, 2, 13, 130, 9000))
    @pytest.mark.parametrize("n", (3, 1000, 1 << 10, 4097, 1 << 15,
                                   1 << 18, 1 << 20, 1 << 22))
    def test_kernel_matches_plain(self, cuda_device, n, n_classes):
        assert_kernel_equals(make_rung("random", n_classes, n, n),
                             n_classes, cuda_device)

    @pytest.mark.parametrize("shape", ("none", "one_class"))
    @pytest.mark.parametrize("n_classes", (1, 13, 9000))
    @pytest.mark.parametrize("n", (3, 1 << 20))
    def test_kernel_edge_shapes(self, cuda_device, n, n_classes, shape):
        assert_kernel_equals(make_rung(shape, n_classes, n, 5), n_classes,
                             cuda_device)

    @pytest.mark.parametrize("cap", ("zero", "one", "third", "all"))
    @pytest.mark.parametrize("n", (3, 1000, 1 << 20))
    def test_kernel_capped(self, cuda_device, n, cap):
        out_size = {"zero": 0, "one": 1, "third": n // 3, "all": n}[cap]
        assert_kernel_equals(make_rung("random", 1, n, 9), 1, cuda_device,
                             out_size)

    def test_kernel_refuses_no_rows(self, cuda_device):
        with pytest.raises(ValueError):
            tsplat.class_rank(torch.zeros(0, dtype=torch.int32,
                                          device=cuda_device), 3)
