"""Port sort (point_cloud_tpu_torch/ops/sort.py) against the reference.

``sort4_reference`` (what ``sort4`` runs on a CPU tensor) is held exactly
against the Pallas kernel in interpret mode, as tests/test_sorts.py runs
it, and against ``np.lexsort``, on random keys and on the shapes that
break merge sorts (equal keys, sorted and reversed input, runs longer
than a kernel tile, i32 extremes in every column). The CUDA kernel itself
is compared with ``sort4_reference`` only where a card exists (``cuda``
marker; it skips here), at lengths below, at and above its 2048-row
tile, with odd and even pass counts. On the card, without JAX:
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_sort.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.ops import sort as tsort


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


def lexsorted(cols):
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], axis=1)


I32_MIN, I32_MAX = -(2**31), 2**31 - 1
TILE_ROWS = 2048  # rows one block of the kernel sorts (csrc/sort4.cu)


def make_cols(kind, n, seed):
    rng = np.random.default_rng(seed)
    arrival = np.arange(n, dtype=np.int32)
    if kind == "extremes":
        # every column, k4 too, takes i32 MIN and MAX; many rows are equal
        choices = np.array([I32_MIN, I32_MIN + 1, -1, 0, I32_MAX - 1, I32_MAX],
                           np.int32)
        return [rng.choice(choices, n) for _ in range(4)]
    if kind in ("presorted", "reversed"):
        cols = [rng.integers(-8, 8, n).astype(np.int32) for _ in range(3)]
        order = np.lexsort(cols[::-1])
        cols = [c[order] for c in cols] + [arrival]
        return [c[::-1].copy() for c in cols] if kind == "reversed" else cols
    if kind == "all_equal":
        cols = [np.full(n, v, np.int32) for v in (7, -3, I32_MAX)]
    elif kind == "long_runs":
        # k1 constant over runs of 1.5 kernel tiles: runs cross the tile
        # and merge-block boundaries
        run = 3 * TILE_ROWS // 2
        n_runs = -(-n // run)
        k1 = np.repeat(rng.integers(-50, 50, n_runs), run)[:n].astype(np.int32)
        cols = [k1, rng.integers(0, 4, n).astype(np.int32),
                rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)]
    elif kind == "random":
        cols = [rng.integers(-1000, 1000, n).astype(np.int32)
                for _ in range(3)]
    elif kind == "duplicates":
        cols = [rng.integers(0, 4, n).astype(np.int32) for _ in range(3)]
    elif kind == "full_range":
        cols = [rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                .astype(np.int32) for _ in range(3)]
        cols[0][:4] = [2**31 - 1, -(2**31), 0, -1]
        cols[1][4:8] = [2**31 - 1, -(2**31), 0, -1]
    elif kind == "dedup_shaped":
        # clamped hashes, padding rows at i32::MAX (tests/test_sorts.py)
        cols = [
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
            rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
        ]
        cols[0][-37:] = 2**31 - 1
        cols[1][-37:] = 0
        cols[2][-37:] = 2**31 - 1
    else:
        raise ValueError(kind)
    return cols + [arrival]


def run_reference(cols):
    out = tsort.sort4_reference(*(torch.from_numpy(c) for c in cols))
    return np.stack([o.numpy() for o in out], axis=1)


KINDS = ["random", "duplicates", "full_range", "dedup_shaped"]
# shapes that break merge sorts: equal keys, sorted runs, extremes
MERGE_KINDS = ["all_equal", "presorted", "reversed", "long_runs", "extremes"]


def pallas_input(cols):
    """``cols`` as the reference takes them: below 2^15 it pads with
    (MAX, MAX, MAX, 2^30 + i) rows and keeps the first n, so a real row
    (MAX, MAX, MAX, k4) needs k4 < 2^30 (``pallas_sort4``)."""
    cols = [c.copy() for c in cols]
    top = (cols[0] == I32_MAX) & (cols[1] == I32_MAX) & (cols[2] == I32_MAX)
    cols[3][top & (cols[3] >= 1 << 30)] = 0
    return cols


@pytest.mark.parametrize("n,kind", [
    *((n, k) for k in KINDS for n in (1 << 10, 1 << 16)),
    *((1 << 10, k) for k in MERGE_KINDS),  # interpret mode is slow
])
def test_reference_matches_pallas_interpret(n, kind):
    import jax.numpy as jnp

    from point_cloud_tpu.ops.sort_pallas import pallas_sort4

    cols = pallas_input(make_cols(kind, n, seed=n))
    got = run_reference(cols)
    ref = pallas_sort4(*(jnp.asarray(c) for c in cols), interpret=True)
    ref = np.stack([np.asarray(r) for r in ref], axis=1)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", KINDS + MERGE_KINDS)
@pytest.mark.parametrize("log_n", [10, 12, 14, 16, 18])
def test_reference_matches_lexsort(kind, log_n):
    cols = make_cols(kind, 1 << log_n, seed=log_n)
    assert np.array_equal(run_reference(cols), lexsorted(cols))


def test_sort4_on_cpu_is_the_reference_and_counts_nothing():
    cols = [torch.from_numpy(c) for c in make_cols("random", 1 << 12, 3)]
    before = tsort.launches
    got = tsort.sort4(*cols)
    ref = tsort.sort4_reference(*cols)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tsort.launches == before


def test_sort4_raises_off_cpu_and_cuda():
    cols = [torch.empty(1 << 12, dtype=torch.int32, device="meta")] * 4
    with pytest.raises(ValueError, match="cuda"):
        tsort.sort4(*cols)


@pytest.mark.parametrize("bad", [
    dict(n=1000), dict(n=512), dict(dtype=torch.int64),
    dict(n=1 << 12, strided=True),
])
def test_kernel_arg_checks_raise(bad):
    n = bad.get("n", 1 << 12)
    dtype = bad.get("dtype", torch.int32)
    cols = [torch.zeros(n * (2 if bad.get("strided") else 1), dtype=dtype)
            for _ in range(4)]
    if bad.get("strided"):
        cols = [c[::2] for c in cols]
    with pytest.raises(ValueError):
        tsort._check_kernel_args(cols)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sort4 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS + MERGE_KINDS)
@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 15, 16, 17, 18, 19, 20, 21, 22])
def test_kernel_matches_reference_on_card(cuda_device, kind, log_n):
    cols = [torch.from_numpy(c).to(cuda_device)
            for c in make_cols(kind, 1 << log_n, seed=log_n)]
    before = tsort.launches
    got = tsort.sort4(*cols)
    torch.cuda.synchronize()
    ref = tsort.sort4_reference(*cols)
    assert tsort.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
