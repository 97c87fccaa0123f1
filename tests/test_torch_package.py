"""Package-level checks of the port: it imports neither jax nor the
reference package, explicit devices, the CLI's backend flags, and the
``conversion`` pipeline against the reference's on the same inputs."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


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

REPO = Path(__file__).resolve().parent.parent


FORBIDDEN = ("jax", "point_cloud_tpu", "bench")


def port_sources():
    return [*sorted((REPO / "point_cloud_tpu_torch").rglob("*.py")),
            REPO / "chip_smoke.py"]


def test_port_imports_no_jax(tmp_path):
    """In a fresh process (tests/conftest.py itself imports jax): import
    every module of the port, run a small --native conversion through
    its CLI, and find no module of jax or of the reference loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import point_cloud_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from point_cloud_tpu_torch.convert import cli\n"
        "from point_cloud_tpu_torch.core.point import PointBatch\n"
        "from point_cloud_tpu_torch.io.ply import write_ply\n"
        "rng = np.random.default_rng(1)\n"
        "src = sys.argv[1] + '/cloud.ply'\n"
        "write_ply(src, PointBatch(\n"
        "    rng.uniform(-20, 20, (3000, 3)).astype(np.float32),\n"
        "    rng.integers(0, 256, (3000, 4)).astype(np.uint8)))\n"
        "assert cli.main(['--native', '--batch-size', '1000', '-o',\n"
        "                 sys.argv[1] + '/store', '-f', src]) == 0\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'point_cloud_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "store" / "metadata.json").exists()


def test_store_server_imports_no_jax():
    """A fresh process that imports the port's server, window and tools
    finds no module of jax or of the reference loaded."""
    code = (
        "import sys\n"
        "import point_cloud_tpu_torch.serve, point_cloud_tpu_torch.export\n"
        "import point_cloud_tpu_torch.validate\n"
        "import point_cloud_tpu_torch.viewer.window\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'point_cloud_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_nothing_of_the_reference(path):
    """No import of jax, of the reference package or of bench.py, at any
    depth of any function of the port or of chip_smoke.py."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert found == []


def test_resolve_device_is_explicit():
    from point_cloud_tpu_torch.ops.runtime import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


@pytest.mark.parametrize("flags", [["--mesh", "2"], ["--multihost",
                                                    "--native"]])
def test_cli_unported_backends_exit_nonzero(tmp_path, flags, monkeypatch):
    """The mesh and multi-host flags: ``--mesh 2`` needs a card on a
    CPU-only host (it raises before any store I/O, like ``--device``);
    ``--multihost --native`` without worker identity in the environment
    runs as the one worker and leaves the merged store at ``-o``."""
    from point_cloud_tpu_torch.convert import cli
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply

    for name in ("PCT_NUM_PROCESSES", "PCT_PROCESS_ID",
                 "PCT_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    src = tmp_path / "x.ply"
    rng = np.random.default_rng(5)
    write_ply(src, PointBatch(
        rng.uniform(-20, 20, (1500, 3)).astype(np.float32),
        rng.integers(0, 256, (1500, 4)).astype(np.uint8)))
    argv = [*flags, "-o", str(tmp_path / "s"), "-f", str(src)]
    if flags[0] == "--mesh":
        if torch.cuda.is_available():
            pytest.skip("a card is present; this checks the CPU-only refusal")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
        assert not (tmp_path / "s").exists()
        return
    assert cli.main(argv) == 0
    meta = json.loads((tmp_path / "s" / "metadata.json").read_text())
    assert meta["number_of_points"] == 1500
    assert not (tmp_path / "s" / "_staging").exists()


@pytest.mark.parametrize("flag", ["--device", "--device-native"])
def test_cli_device_native_needs_a_card(tmp_path, flag):
    from point_cloud_tpu_torch.convert import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([flag, "-o", str(tmp_path / "s"),
                  "-f", str(tmp_path / "x.ply")])
    assert not (tmp_path / "s").exists()


def test_cli_native_matches_reference_cli(tmp_path, capsys):
    """--native goes to the port's copy of the C++ engine's converter: the
    same store as the reference CLI, and --profile ends stdout with the
    JSON summary."""
    from point_cloud_tpu.convert import cli as ref_cli
    from point_cloud_tpu.core.point import PointBatch
    from point_cloud_tpu.io.ply import write_ply
    from point_cloud_tpu.native import hex_lockstep_ok
    from point_cloud_tpu_torch.convert import cli
    from point_cloud_tpu_torch.native import hex_lockstep_ok as port_ok

    if not (hex_lockstep_ok() and port_ok()):
        pytest.skip("no C++ toolchain for the engine")
    rng = np.random.default_rng(5)
    src = tmp_path / "cloud.ply"
    write_ply(src, PointBatch(
        rng.uniform(-50, 50, (6000, 3)).astype(np.float32),
        rng.integers(0, 256, (6000, 4)).astype(np.uint8),
    ))
    common = ["--batch-size", "2000", "-f", str(src)]
    assert ref_cli.main(["--native", "-o", str(tmp_path / "ref"), *common]) == 0
    capsys.readouterr()
    assert cli.main(["--native", "--profile", "-o", str(tmp_path / "port"),
                     *common]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["points"] == 6000 and summary["convert_s"] > 0
    assert set(summary["launches"]) == {"sort4", "quantize_sort4",
                                        "mark_pack"}
    assert set(summary["launches_by_n"]) == {"sort4", "quantize_sort4",
                                             "quantize_sort4_gather"}
    assert isinstance(summary["stages"], dict)
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert files
    for rel in files:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "ref" / rel).read_bytes())


def test_conversion_pipeline_matches_reference():
    """get_pipeline("conversion") runs the port's full dedup pass on the
    reference's inputs; the per-row keys and flags match the JAX pass."""
    from point_cloud_tpu.models import get_pipeline as ref_pipeline
    from point_cloud_tpu_torch.models import get_pipeline

    n = 1 << 15
    fn, args = get_pipeline("conversion", n=n, seed=3, device="cpu")
    ref_fn, ref_args = ref_pipeline("conversion", n=n, seed=3)
    assert np.array_equal(args[0].numpy(), np.asarray(ref_args[0]))
    for a, r in zip(args[2:], ref_args[2:]):
        assert a.item() == float(np.asarray(r))
    got = [o.numpy() for o in fn(*args)]
    ref = [np.asarray(o) for o in ref_fn(*ref_args)]
    assert len(got) == len(ref) == 8
    # sparse uniform cloud: no near-tie runs, so every output but the
    # (fma-sensitive, docs/PERF_TPU_V5E.md) distance column is exact
    for i in (0, 1, 2, 3, 4, 6, 7):
        assert np.array_equal(got[i], ref[i]), i
    assert got[0].shape == (n,) and got[3].shape == (n, 3)


def test_frame_pipeline_matches_reference():
    """get_pipeline("frame") runs the port's cull_lod_pass (the LOD walk,
    then the cull) on the reference's inputs and matches the JAX pass
    exactly; an unknown pipeline name raises KeyError."""
    from point_cloud_tpu.models import get_pipeline as ref_pipeline
    from point_cloud_tpu_torch.models import get_pipeline

    fn, args = get_pipeline("frame", n=1 << 12, seed=2, device="cpu")
    ref_fn, ref_args = ref_pipeline("frame", n=1 << 12, seed=2)
    for a, r in zip(args[:10], ref_args[:10]):
        assert np.array_equal(a.numpy(), np.asarray(r))
    got = [o.numpy() for o in fn(*args)]
    ref = [np.asarray(o) for o in ref_fn(*ref_args)]
    assert len(got) == len(ref) == 3
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert np.array_equal(got[2].view(np.int32), ref[2].view(np.int32))
    assert got[0].sum() > 0
    with pytest.raises(KeyError):
        get_pipeline("nope", device="cpu")
