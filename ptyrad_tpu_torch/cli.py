"""Command-line interface (counterpart of ptyrad_tpu/cli.py).

    python -m ptyrad_tpu_torch <command> ...   (or the ptyrad-tpu-torch script)

  run               -- a reconstruction from a params file, on the card
                       (``--device cpu`` for the plain PyTorch path), or a
                       hypertune study when hypertune_params.if_hypertune
                       (``--jobid`` labels the worker and its log file)
  check-gpu         -- the CUDA report; exit 1 without CUDA
  print-system-info -- platform, packages and the CUDA report
  export-meas-init  -- run the measurement initialisation and export it
  validate-params   -- validate a params file; exit 1 when it is invalid

``main()`` returns the exit code. One process on one device: ``--n_devices``
above 1, ``--multihost`` and the three distributed flags are ROADMAP item A6
(the distributed flags without ``--multihost`` fail at once, as in the JAX
package), and ``bench`` belongs to the JAX package.
"""

from __future__ import annotations

import argparse
import sys

_DIST_FLAGS = ("coordinator_address", "num_processes", "process_id")


def _jobid_prefix(jobid) -> str:
    """The log file's job-id prefix: only a nonzero hypertune worker id."""
    return "" if jobid in ("0", 0, None, "") else str(jobid)


def _apply_common_overrides(params: dict, args) -> None:
    """CLI flags that override params-file fields."""
    if getattr(args, "mixed_precision", False):
        params.setdefault("model_params", {})["compute_dtype"] = "bfloat16"


def cmd_run(args) -> int:
    from ptyrad_tpu_torch.device import resolve_device
    from ptyrad_tpu_torch.load import load_params
    from ptyrad_tpu_torch.utils.logging import CustomLogger
    from ptyrad_tpu_torch.utils.system import print_system_info, resolve_devices

    given = [f"--{k}" for k in _DIST_FLAGS if getattr(args, k, None) is not None]
    if given and not args.multihost:
        raise SystemExit(f"{', '.join(given)} requires --multihost (the flags are only read "
                         "by a distributed launch)")
    if args.multihost:
        raise NotImplementedError("--multihost: ptyrad_tpu_torch runs one process on one "
                                  "device; distributed runs are ROADMAP item A6")
    resolve_devices(args.n_devices)
    device = resolve_device(args.device)
    logger = CustomLogger(log_file="ptyrad_tpu_torch_log.txt",
                          prefix_jobid=_jobid_prefix(args.jobid), append_to_file=True,
                          show_timestamp=True)
    try:
        print_system_info()
        params = load_params(args.params_path, validate=not args.skip_validate)
        _apply_common_overrides(params, args)
        if (params.get("hypertune_params") or {}).get("if_hypertune"):
            from ptyrad_tpu_torch.engine.hypertune import run_hypertune

            run_hypertune(params, logger=logger, jobid=args.jobid, device=device)
        else:
            from ptyrad_tpu_torch.engine.workflow import run_reconstruction

            run_reconstruction(params, logger=logger, device=device)
    finally:
        logger.close()
    return 0


def cmd_check_gpu(args) -> int:
    from ptyrad_tpu_torch.utils.system import print_device_info

    return 0 if print_device_info() else 1


def cmd_print_system_info(args) -> int:
    from ptyrad_tpu_torch.utils.system import print_system_info

    print_system_info()
    return 0


def cmd_export_meas_init(args) -> int:
    """The params file's meas_export, overridden by --output (its directory,
    stem and extension give file_dir, file_name and file_format), --reshape
    and --append (the shape in the file name; off unless given)."""
    from pathlib import Path

    from ptyrad_tpu_torch.initialization import Initializer
    from ptyrad_tpu_torch.load import load_params

    params = load_params(args.params_path, validate=not args.skip_validate)
    init_params = dict(params["init_params"])
    export_cfg = init_params.get("meas_export")
    if export_cfg in (True, False, None):
        export_cfg = {}
    elif not isinstance(export_cfg, dict):
        raise TypeError("`meas_export` in init_params must be True, False, None, or a dict")
    export_cfg = dict(export_cfg)
    if args.output:
        output_path = Path(args.output)
        export_cfg["file_dir"] = str(output_path.parent)
        export_cfg["file_name"] = output_path.stem
        export_cfg["file_format"] = output_path.suffix.lstrip(".") or "hdf5"
    else:
        export_cfg.setdefault("file_dir", "")
        export_cfg.setdefault("file_name", "ptyrad_init_meas")
        export_cfg.setdefault("file_format", "hdf5")
    if args.reshape:
        export_cfg["output_shape"] = tuple(args.reshape)
    export_cfg["append_shape"] = args.append
    init_params["meas_export"] = export_cfg
    Initializer(init_params).init_measurements()
    print("Exported processed measurements.")
    return 0


def cmd_validate_params(args) -> int:
    from ptyrad_tpu_torch.load import load_params

    try:
        load_params(args.params_path, validate=True)
    except Exception as e:  # noqa: BLE001 — one line and exit 1, not a traceback
        print(f"Invalid parameters: {e}")
        return 1
    print(f"Params file '{args.params_path}' is valid.")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ptyrad-tpu-torch",
        description="Ptychographic reconstruction with automatic differentiation on an "
                    "NVIDIA GPU (PyTorch and hand-written CUDA kernels)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="Run a reconstruction")
    p_run.add_argument("--params_path", required=True,
                       help="Path to the params file (.yml/.toml/.json/.py)")
    p_run.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="cuda (the default; raises without CUDA) or cpu (the plain "
                            "PyTorch path)")
    p_run.add_argument("--n_devices", type=int, default=None,
                       help="Number of devices (one; more is ROADMAP item A6)")
    p_run.add_argument("--jobid", default="0",
                       help="Job id label for the log file (a hypertune worker's)")
    p_run.add_argument("--skip_validate", action="store_true", help="Skip params validation")
    p_run.add_argument("--mixed_precision", action="store_true",
                       help="Set model_params.compute_dtype to bfloat16 (not ported yet: "
                            "ROADMAP item A8)")
    p_run.add_argument("--multihost", action="store_true",
                       help="Distributed launch (ROADMAP item A6)")
    p_run.add_argument("--coordinator_address", default=None,
                       help="host:port of a distributed launch (needs --multihost)")
    p_run.add_argument("--num_processes", type=int, default=None)
    p_run.add_argument("--process_id", type=int, default=None)
    p_run.set_defaults(func=cmd_run)

    p_check = sub.add_parser("check-gpu", help="Report the CUDA devices; exit 1 without one")
    p_check.set_defaults(func=cmd_check_gpu)

    p_info = sub.add_parser("print-system-info", help="Print system, package and device info")
    p_info.set_defaults(func=cmd_print_system_info)

    p_export = sub.add_parser("export-meas-init", help="Export initialized measurements")
    p_export.add_argument("--params_path", required=True)
    p_export.add_argument("--skip_validate", action="store_true")
    p_export.add_argument("--output", type=str, default=None,
                          help="Optional output path / file type (.mat, .hdf5, .tif, .npy)")
    p_export.add_argument("--reshape", type=int, nargs="+", default=None,
                          help="Optional new shape, e.g. --reshape 128 128 128 128")
    p_export.add_argument("--append", action="store_true",
                          help="Append the array shape to the file name")
    p_export.set_defaults(func=cmd_export_meas_init)

    p_val = sub.add_parser("validate-params", help="Validate a params file")
    p_val.add_argument("--params_path", required=True)
    p_val.set_defaults(func=cmd_validate_params)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return int(args.func(args) or 0)


if __name__ == "__main__":
    sys.exit(main())
