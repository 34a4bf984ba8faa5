"""The port stands alone and never falls back quietly.

* glomap_tpu_torch and chip_smoke.py import neither jax nor glomap_tpu:
  a subprocess where both are blocked imports every module, and an ast
  scan finds no such import statement anywhere in the port's sources.
* With device=None and no CUDA, the entry point raises instead of
  running on the CPU.
* A kernel whose build fails raises; its CUDA launch never hands back
  the plain version's result, and neither does stage 7's triangulation
  nor the `mapper` command, which lets the error out before it writes.
  The native track engine's loader raises when g++ fails, for the track
  engine and for the connected components of the strong clustering
  alike: it has no Python fallback. In parallel/, no `try` wraps a
  process group, a device or a solver, and a backend that fails raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glomap_tpu_torch.config import BundleAdjusterOptions
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.ops import _build, kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis
from glomap_tpu_torch.scene.arrays import Scene, Tracks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "glomap_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "glomap_tpu")


def _port_modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    """Every module, and chip_smoke, with jax and glomap_tpu blocked."""
    code = (
        "import sys\n"
        "for name in %r: sys.modules[name] = None\n"
        "import importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'glomap_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n" % (FORBIDDEN, _port_modules()))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


PARALLEL_FILES = sorted((PORT / "parallel").glob("*.py"))
# what a `try` in parallel/ may call: the partitioner's ARPACK retries
# (a numerical fallback of the eigensolver, as in the JAX package)
PARALLEL_TRY_CALLS = {"eigsh", "argsort"}


@pytest.mark.parametrize("path", PARALLEL_FILES,
                         ids=[p.name for p in PARALLEL_FILES])
def test_parallel_has_no_backend_or_kernel_fallback(path):
    """No `try ... except` in parallel/ wraps a process-group call, a
    device choice or a solver: a failed NCCL, gloo or kernel raises. The
    partitioner's eigensolver retries are the one `except`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try) or not node.handlers:
            continue  # try/finally cleans up and catches nothing
        called = {c.func.attr if isinstance(c.func, ast.Attribute)
                  else getattr(c.func, "id", "?")
                  for stmt in node.body for c in ast.walk(stmt)
                  if isinstance(c, ast.Call)}
        assert called <= PARALLEL_TRY_CALLS, \
            f"{path.name}:{node.lineno} tries {sorted(called)}"


def test_process_group_failure_raises():
    """A backend that does not exist raises, and no group is left."""
    import torch.distributed as dist
    from glomap_tpu_torch.parallel import multihost
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        multihost.initialize("tcp://localhost:1", 1, 0, "cpu",
                             backend="no-such-backend")
    assert not dist.is_initialized()


def _tiny_problem():
    """Three frames, one PINHOLE camera, four points seen by all three."""
    F, P = 3, 4
    scene = Scene(
        camera_ids=np.array([1]), cam_model_id=np.array([1], np.int32),
        cam_params=np.array([[500.0, 500.0, 320, 240] + [0.0] * 12]),
        cam_kind=np.zeros(1, np.int32),
        sensor_quat=np.array([[1.0, 0, 0, 0]]), sensor_trans=np.zeros((1, 3)),
        sensor_is_ref=np.array([True]),
        frame_ids=np.arange(1, F + 1),
        frame_quat=np.tile([1.0, 0, 0, 0], (F, 1)),
        frame_trans=np.array([[0.0, 0, 0], [-1.0, 0, 0], [0, -1.0, 0]]),
        frame_registered=np.ones(F, bool),
        image_ids=np.arange(1, F + 1), image_frame=np.arange(F, dtype=np.int32),
        image_camera=np.zeros(F, np.int32), image_sensor=np.zeros(F, np.int32),
        kp_xy=300.0 + np.arange(F * P * 2, dtype=float).reshape(F * P, 2),
        kp_offset=np.arange(0, F * P + 1, P))
    tracks = Tracks(
        xyz=np.array([[0.0, 0, 5], [1, 0, 6], [0, 1, 7], [1, 1, 8]]),
        valid=np.ones(P, bool), color=np.zeros((P, 3), np.uint8),
        obs_track=np.tile(np.arange(P, dtype=np.int32), F),
        obs_image=np.repeat(np.arange(F, dtype=np.int32), P),
        obs_feature=np.tile(np.arange(P, dtype=np.int32), F),
        obs_valid=np.ones(F * P, bool))
    return scene, tracks


def test_default_device_without_cuda_raises(monkeypatch):
    """device=None means CUDA; without it the solve raises and leaves the
    scene untouched (it never carries on on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, tracks = _tiny_problem()
    before = scene.frame_trans.copy(), tracks.xyz.copy()
    with pytest.raises(RuntimeError, match="CUDA"):
        tba.solve_bundle_adjustment(
            scene, tracks, BundleAdjusterOptions(max_num_iterations=2))
    np.testing.assert_array_equal(scene.frame_trans, before[0])
    np.testing.assert_array_equal(tracks.xyz, before[1])
    # the same problem does run where the CPU is asked for
    assert tba.solve_bundle_adjustment(
        scene, tracks, BundleAdjusterOptions(max_num_iterations=2),
        dtype=torch.float64, device="cpu")


def test_gp_default_device_without_cuda_raises(monkeypatch):
    """Global positioning too: device=None means CUDA, and without it the
    solve raises before it touches the scene."""
    from glomap_tpu_torch.estimators import global_positioning as tgp
    from glomap_tpu_torch.scene.view_graph import ViewGraph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, tracks = _tiny_problem()
    before = scene.frame_trans.copy()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgp.solve_global_positioning(scene, ViewGraph(), tracks)
    np.testing.assert_array_equal(scene.frame_trans, before)


class _BuildFailed(RuntimeError):
    pass


@pytest.fixture
def broken_build(monkeypatch):
    """_build raises for every kernel, and no library is loaded yet."""
    def fail(*args, **kwargs):
        raise _BuildFailed("nvcc failed (simulated)")
    monkeypatch.setattr(_build, "build", fail)
    monkeypatch.setattr(_build, "library", fail)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(kernels, "_entries", {})


def _launch_cases():
    """(name, CUDA launch function, its arguments) on float32 CPU tensors:
    the launch path must raise before it looks at the device."""
    O, g = 64, torch.Generator().manual_seed(0)

    def rows(k):
        return torch.randn((k, O), generator=g)
    ax = SegmentAxis.build(torch.randint(0, 5, (O,), generator=g), 5)
    pairs = ((((0, 0),), ((1, 1),)))
    return [
        ("projection_resid_jac", kernels._projection_resid_jac_cuda,
         (rows(9), rows(9), rows(3), rows(3), rows(2), rows(16), rows(1))),
        ("gather", kernels._gather_cuda, (torch.randn(5, 4), ax)),
        ("rowsum", kernels._rowsum_cuda, (rows(4), ax)),
        ("pair_rowsum", kernels._pair_rowsum_cuda,
         (rows(2), rows(2), pairs, ax)),
        ("sampson_score", kernels._sampson_score_cuda,
         (rows(9), rows(3), rows(3))),
        ("gather_dot", kernels._gather_dot_cuda,
         (torch.randn(5, 4), rows(8), ax)),
        ("huber_irls", kernels._huber_irls_cuda,
         (rows(2), 1.0, torch.rand(O, generator=g))),
    ]


@pytest.mark.parametrize("case", range(7),
                         ids=[c[0] for c in _launch_cases()])
def test_cuda_launch_raises_when_build_fails(broken_build, case):
    name, launch, args = _launch_cases()[case]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(_BuildFailed):
        launch(*args)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("case", range(7),
                         ids=[c[0] for c in _launch_cases()])
def test_wrapper_takes_kernel_path_off_cpu(broken_build, case):
    """A tensor that is not on the CPU (here on the meta device) goes to
    the kernel path, which raises: the wrapper has no fallback."""
    name, _, args = _launch_cases()[case]
    wrapper = getattr(kernels, name)
    meta = []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = a.to("meta")
        elif isinstance(a, SegmentAxis):
            a = SegmentAxis(a.ids.to("meta"), a.perm.to("meta"),
                            a.offsets.to("meta"), a.n_seg)
        meta.append(a)
    with pytest.raises(_BuildFailed):
        wrapper(*meta)


def _triangulation_case(name):
    """(function, arguments) of stage 7's triangulation on the meta
    device: its first kernel (B3 for the midpoint, B2 for the RANSAC
    score) must take the kernel path and raise."""
    from glomap_tpu_torch.ops import triangulation as ttri
    g = torch.Generator().manual_seed(0)
    ids = torch.repeat_interleave(torch.arange(5), torch.tensor(
        [3, 0, 4, 2, 5]))
    ax = SegmentAxis.build(ids, 5)
    ax = SegmentAxis(ax.ids.to("meta"), ax.perm.to("meta"),
                     ax.offsets.to("meta"), ax.n_seg)
    dT = torch.nn.functional.normalize(torch.randn((3, 14), generator=g),
                                       dim=0).to("meta")
    cT = torch.randn((3, 14), generator=g).to("meta")
    if name == "midpoint_triangulate":
        return ttri.midpoint_triangulate, (ax, dT, cT,
                                           torch.ones(14, device="meta"))
    t_len = torch.tensor([3, 0, 4, 2, 5])
    t_start = torch.cumsum(t_len, 0) - t_len
    return ttri.ransac_triangulate, (ax, dT, cT, t_start.to("meta"),
                                     t_len.to("meta"), 16, 0.99, 0.017)


@pytest.mark.parametrize("name", ["midpoint_triangulate",
                                  "ransac_triangulate"])
def test_triangulation_takes_kernel_path_off_cpu(broken_build, name):
    """Stage 7's triangulation on a tensor that is not on the CPU launches
    its kernels, and raises with the build: no plain fallback."""
    fn, args = _triangulation_case(name)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(_BuildFailed):
        fn(*args)
    assert kernels.LAUNCHES == before


def _break_native_build(monkeypatch, tmp_path, fault):
    """No library loaded yet, builds go to tmp_path, and g++ fails."""
    from glomap_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    if fault == "compile-error":
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ["-fno-such-option"])
    else:
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    return native


@pytest.mark.parametrize("fault", ["compile-error", "no-compiler"])
def test_native_connected_components_build_failure_raises(
        monkeypatch, tmp_path, fault):
    """The strong clustering's connected components (pruning) come from
    the same library: a failed build raises, there is no scipy path."""
    native = _break_native_build(monkeypatch, tmp_path, fault)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.connected_components(4, np.array([0, 2]), np.array([1, 3]))
    assert native._lib is None
    assert not list((tmp_path / "native").glob("*.so*"))


@pytest.mark.parametrize("fault", ["compile-error", "no-compiler"])
def test_native_build_failure_raises(monkeypatch, tmp_path, fault):
    """The track engine is built by g++ at first use; when that fails the
    loader raises (no Python fallback) and leaves no library behind."""
    native = _break_native_build(monkeypatch, tmp_path, fault)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.establish_tracks(4, np.array([0, 2]), np.array([1, 3]))
    assert native._lib is None
    assert not list((tmp_path / "native").glob("*.so*"))


def test_mapper_command_raises_when_build_fails(broken_build, monkeypatch,
                                                tmp_path):
    """The `mapper` command with every kernel wrapper on its launch path
    (as on the card) and every build failing: the first kernel of the
    path (B3, in stage 1's normal equations) raises out of the command;
    no stage catches it, and no model is written."""
    from glomap_tpu_torch import cli
    from glomap_tpu_torch.io.database import write_database
    from glomap_tpu_torch.utils.synthetic import (SyntheticOptions,
                                                  synthesize_dataset)
    for name, launch, _ in _launch_cases():
        monkeypatch.setattr(kernels, name, launch)
    scene, vg, _ = synthesize_dataset(SyntheticOptions(
        num_frames_per_rig=4, num_points3D=60, seed=2))
    db = str(tmp_path / "db.sqlite")
    write_database(db, scene, vg)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(_BuildFailed):
        cli.main(["mapper", "--database_path", db, "--output_path",
                  str(tmp_path / "out"), "--device", "cpu"])
    assert kernels.LAUNCHES == before
    assert not (tmp_path / "out").exists()
