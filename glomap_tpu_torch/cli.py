"""CLI: glomap_tpu_torch mapper, mapper_resume and rotation_averager.

Counterpart of glomap_tpu/cli.py (the reference's glomap/glomap.cc and
exe/: RunMapper :16, RunMapperResume :108, the rotation averager's
command) with the same dotted flag surface as the reference's
OptionManager (--BundleAdjustment.optimize_principal_point=1 etc.;
config.py holds the whole registry):

    python -m glomap_tpu_torch.cli mapper --database_path DB \\
        --output_path O [--image_path I] [--checkpoint_dir D] [--device cpu]
        [--distributed]
    python -m glomap_tpu_torch.cli mapper_resume --input_path M \\
        --output_path O [--checkpoint_dir D] [--device cpu] [--distributed]
    python -m glomap_tpu_torch.cli rotation_averager --relpose_path R \\
        --output_path O [--gravity_path G [--refine_gravity]] \\
        [--weight_path W] [--device cpu]

The solvers run on the CUDA card unless --device names another device;
without a card and without --device cpu a command fails before it reads
its input. With --distributed, each process is one rank of a
torch.distributed group, named by GLOMAP_COORDINATOR (tcp://host:port or
file:///path), GLOMAP_NUM_PROCESSES and GLOMAP_PROCESS_ID: NCCL on the
rank's card, cuda:(rank % device_count), or gloo with --device cpu. The
solvers of stages 3 and 5-7 split their work over the ranks
(device_mesh_shape = (world size,)), every rank computes the same model,
and only rank 0 writes it. A process that has joined a group already
(several ranks on one card, under gloo) runs in that group.
"""

from __future__ import annotations

import argparse
import logging
import sys

from glomap_tpu_torch import config as cfg

# reference dotted-module prefixes -> the nested option fields
_MODULE_ALIAS = {
    "ViewGraphCalib": "opt_vgcalib",
    "RelPoseEstimation": "opt_relpose",
    "RotationEstimator": "opt_ra",
    "RotationAveraging": "opt_ra",
    "TrackEstablishment": "opt_track",
    "GlobalPositioning": "opt_gp",
    "BundleAdjustment": "opt_ba",
    "Triangulation": "opt_triangulator",
    "GravityRefiner": "opt_gravity_refiner",
    "Thresholds": "inlier_thresholds",
}

# reference top-level flags (option_manager.cc:65-68) -> the fields
_TOP_ALIAS = {
    "ba_iteration_num": "num_iteration_bundle_adjustment",
    "retriangulation_iteration_num": "num_iteration_retriangulation",
}


def _resolve_flag_name(name: str) -> str | None:
    """Reference flag spelling -> dotted field path (None = consumed)."""
    if name in _TOP_ALIAS:
        return _TOP_ALIAS[name]
    if name.endswith(".use_gpu") or name.endswith(".gpu_index"):
        return None  # the reference's GPU toggles: --device chooses here
    parts = name.split(".")
    if len(parts) == 2 and parts[0] in _MODULE_ALIAS:
        field = parts[1]
        # the reference's triangulation flags drop the tri_ prefix
        if parts[0] == "Triangulation" and field in (
                "complete_max_reproj_error", "merge_max_reproj_error",
                "min_angle"):
            field = "tri_" + field
        return _MODULE_ALIAS[parts[0]] + "." + field
    return name


def _apply_log_flags(name: str, value: str) -> bool:
    """Handle the reference's glog flags (option_manager.cc:23-24):
    log_to_stderr (FLAGS_logtostderr) and log_level (FLAGS_v)."""
    if name == "log_to_stderr":
        # consumed: python logging writes to stderr already
        return True
    if name == "log_level":
        # glog -v: 0 = default, >= 1 = verbose
        logging.getLogger().setLevel(
            logging.DEBUG if int(value) >= 1 else logging.INFO)
        return True
    return False


def _apply_dotted_flags(opt, unknown_args, flat_ok=False):
    """Map --Module.option=value / --Module.option value onto the options,
    accepting the reference OptionManager's flag spellings (its
    AddAndRegister*Option names, the top-level ba_iteration_num /
    retriangulation_iteration_num and the log_* flags). flat_ok: `opt` is
    a flat options object (rotation_averager's), so a dotted name falls
    back to its last part."""
    i = 0
    while i < len(unknown_args):
        arg = unknown_args[i]
        if not arg.startswith("--"):
            i += 1
            continue
        body = arg[2:]
        if "=" in body:
            name, value = body.split("=", 1)
            i += 1
        else:
            name = body
            value = unknown_args[i + 1] if i + 1 < len(unknown_args) else ""
            i += 2
        if _apply_log_flags(name, value):
            continue
        name = _resolve_flag_name(name)
        if name is None:
            continue
        try:
            cfg.set_option(opt, name, value)
        except AttributeError:
            try:
                if not flat_ok:
                    raise
                cfg.set_option(opt, name.split(".")[-1], value)
            except AttributeError:
                # the reference's boost::program_options rejects unknown
                # options (option_manager.cc Parse): a misspelt flag must
                # not run with the defaults
                print(f"error: unrecognised option '--{name}'",
                      file=sys.stderr)
                raise SystemExit(2)
    return opt


def _registry_epilog(opt) -> str:
    """--help dump of the dotted-flag registry with its defaults (the
    reference prints its program_options description,
    option_manager.cc:322-327)."""
    rev = {}
    for mod, fld in _MODULE_ALIAS.items():
        rev.setdefault(fld, mod)
    rev_top = {v: k for k, v in _TOP_ALIAS.items()}
    lines = ["The following options can be specified via command-line:",
             "  --log_to_stderr (default: false)",
             "  --log_level (default: 0)"]
    for name, val in cfg.flatten_options(opt).items():
        parts = name.split(".")
        if len(parts) == 2 and parts[0] in rev:
            field = parts[1]
            if parts[0] == "opt_triangulator" and field.startswith("tri_") \
                    and field in ("tri_complete_max_reproj_error",
                                  "tri_merge_max_reproj_error",
                                  "tri_min_angle"):
                field = field[4:]
            disp = rev[parts[0]] + "." + field
        else:
            disp = rev_top.get(name, name)
        if isinstance(val, bool):
            val = str(val).lower()
        lines.append(f"  --{disp} (default: {val})")
    return "\n".join(lines)


def _device_or_exit(name):
    """The solvers' device, or None after printing why there is none."""
    from glomap_tpu_torch.device import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _enter_distributed(opt, device) -> tuple:
    """Join the process group that GLOMAP_COORDINATOR,
    GLOMAP_NUM_PROCESSES and GLOMAP_PROCESS_ID name (parallel/multihost:
    NCCL on the rank's card, gloo for a CPU device), unless this process
    has joined one already, and put the solvers on the world's ranks:
    device_mesh_shape = (world size,). Returns (whether this rank is the
    primary, which writes the outputs; whether this call joined the
    group). Missing variables raise initialize's ValueError."""
    import torch.distributed as dist

    from glomap_tpu_torch.parallel import multihost
    joined = not dist.is_initialized()
    if joined:
        multihost.initialize(device="cpu" if device.type == "cpu" else None)
    opt.device_mesh_shape = (multihost.world()[1],)
    return multihost.is_primary(), joined


def _solver_device(args, opt):
    """(the solvers' device, whether this rank writes the outputs, whether
    it joined a group it must leave), or None after printing why the
    command cannot run."""
    device = _device_or_exit(args.device)
    if device is None:
        return None
    if not args.distributed:
        return device, True, False
    try:
        primary, joined = _enter_distributed(opt, device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return None
    # the rank's own card, which initialize made the current device
    return _device_or_exit(args.device), primary, joined


def _leave(joined: bool) -> None:
    if joined:
        from glomap_tpu_torch.parallel import multihost
        multihost.shutdown()


def run_mapper(args, extra):
    from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
    from glomap_tpu_torch.io.convert import (database_to_scene,
                                             write_reconstruction)
    from glomap_tpu_torch.io.database import read_database
    from glomap_tpu_torch.utils.profiling import span

    opt = _apply_dotted_flags(cfg.GlobalMapperOptions(), extra)
    if args.checkpoint_dir:
        opt.checkpoint_dir = args.checkpoint_dir
    entered = _solver_device(args, opt)
    if entered is None:
        return 1
    device, primary, joined = entered
    try:
        mapper = GlobalMapper(opt, device=device)
        logging.info("Loading database %s", args.database_path)
        with mapper.timer.stage("read database"):
            with span("read database/files"):
                db = read_database(args.database_path)
            with span("read database/scene"):
                scene, vg = database_to_scene(db)
        tracks = mapper.solve(scene, vg)
    finally:
        _leave(joined)
    if tracks is None:
        print("mapper failed", file=sys.stderr)
        return 1
    if not primary:
        return 0
    if args.image_path:
        from glomap_tpu_torch.processors.color_extraction import (
            extract_colors)
        with mapper.timer.stage("extract colors"):
            extract_colors(scene, tracks, args.image_path)
    with mapper.timer.stage("write model"):
        dirs = write_reconstruction(args.output_path, scene, tracks,
                                    binary=args.output_format == "bin")
    print(f"Reconstruction written to: {', '.join(dirs)}")
    return 0


def run_mapper_resume(args, extra):
    from glomap_tpu_torch.controllers.global_mapper import GlobalMapper
    from glomap_tpu_torch.io.convert import (model_to_scene,
                                             write_reconstruction)
    from glomap_tpu_torch.scene.view_graph import ViewGraph

    opt = _apply_dotted_flags(cfg.mapper_resume_options(), extra)
    if args.checkpoint_dir:
        opt.checkpoint_dir = args.checkpoint_dir
    entered = _solver_device(args, opt)
    if entered is None:
        return 1
    device, primary, joined = entered
    try:
        mapper = GlobalMapper(opt, device=device)
        with mapper.timer.stage("read model"):
            scene, tracks = model_to_scene(args.input_path)
        tracks = mapper.solve(scene, ViewGraph(), tracks)
    finally:
        _leave(joined)
    if tracks is None:
        print("mapper_resume failed", file=sys.stderr)
        return 1
    if not primary:
        return 0
    with mapper.timer.stage("write model"):
        dirs = write_reconstruction(args.output_path, scene, tracks,
                                    binary=args.output_format == "bin")
    print(f"Reconstruction written to: {', '.join(dirs)}")
    return 0


def run_rotation_averager(args, extra):
    from glomap_tpu_torch.controllers.rotation_averager import (
        RotationAveragerOptions, solve_rotation_averaging)
    from glomap_tpu_torch.estimators.gravity_refinement import refine_gravity
    from glomap_tpu_torch.io import pose_io
    from glomap_tpu_torch.scene.arrays import Scene

    opts = RotationAveragerOptions()
    opts.use_gravity = bool(args.gravity_path)
    _apply_dotted_flags(opts, extra, flat_ok=True)
    device = _device_or_exit(args.device)
    if device is None:
        return 1
    scene = Scene()
    vg = pose_io.read_rel_pose(args.relpose_path, scene)
    if args.weight_path:
        opts.use_weight = True
        pose_io.read_rel_weight(args.weight_path, scene, vg)
    if args.gravity_path:
        pose_io.read_gravity(args.gravity_path, scene)
        if args.refine_gravity:
            refine_gravity(scene, vg)
    vg.keep_largest_connected_component(scene)
    if not solve_rotation_averaging(scene, vg, opts, device=device):
        print("rotation averaging failed", file=sys.stderr)
        return 1
    pose_io.write_global_rotations(args.output_path, scene)
    print(f"Global rotations written to: {args.output_path}")
    return 0


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(
        prog="glomap_tpu_torch",
        description="Global structure-from-motion on PyTorch and CUDA "
                    "(the port of glomap_tpu)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mapper", help="full global SfM from a COLMAP db",
                       epilog=_registry_epilog(cfg.GlobalMapperOptions()),
                       formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--database_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--image_path", default="",
                   help="the images, for the points' colors (needs PIL)")
    p.add_argument("--output_format", default="bin", choices=["bin", "txt"])
    p.add_argument("--checkpoint_dir", default="",
                   help="write stage_NN.npz after every pipeline stage "
                        "and auto-resume from the latest on restart")
    p.add_argument("--device", default=None,
                   help="torch device of the solvers (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch path in f64)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group of "
                        "GLOMAP_COORDINATOR / GLOMAP_NUM_PROCESSES / "
                        "GLOMAP_PROCESS_ID and split the solvers over its "
                        "ranks")
    p.set_defaults(func=run_mapper)

    p = sub.add_parser("mapper_resume",
                       help="resume from an existing reconstruction "
                            "(global positioning + BA only)",
                       epilog=_registry_epilog(cfg.mapper_resume_options()),
                       formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--image_path", default="",
                   help="accepted for the reference's command line; unused")
    p.add_argument("--output_format", default="bin", choices=["bin", "txt"])
    p.add_argument("--checkpoint_dir", default="",
                   help="write stage_NN.npz after every pipeline stage "
                        "and auto-resume from the latest on restart")
    p.add_argument("--device", default=None,
                   help="torch device of the solvers (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch path)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group and split the "
                        "solvers over its ranks")
    p.set_defaults(func=run_mapper_resume)

    p = sub.add_parser("rotation_averager",
                       help="standalone rotation averaging from a relative"
                            " pose file")
    p.add_argument("--relpose_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--gravity_path", default="")
    p.add_argument("--weight_path", default="")
    p.add_argument("--refine_gravity", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the solvers (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch path in f64)")
    p.set_defaults(func=run_rotation_averager)

    args, extra = parser.parse_known_args(argv)
    from glomap_tpu_torch.utils.profiling import span

    # the command's root span: its stages and their spans are children
    with span(args.command):
        return args.func(args, extra)


if __name__ == "__main__":
    sys.exit(main())
