"""What the bench, drive and pipeline tools share: the device's
synchronisation, the line that names the card a number was measured on,
the chunked oracle trace and the in-process runner of a CLI's main."""

from __future__ import annotations

import contextlib
import importlib
import os
import subprocess
import traceback

import torch


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a host
    clock read after it covers that work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or a
    line saying that the numbers come from the CPU."""
    if torch.device(device).type != "cuda":
        return "device: cpu (plain PyTorch path; no device time measured)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    return out.splitlines()[0] if out else torch.cuda.get_device_name(0)


def oracle_trace(inputs, alive, ro, rd, transmittance_min: float,
                 chunk: int, sh_deg: int = 3):
    """The brute-force trace (grid_tracer.trace_reference: every surfel
    against every ray) of rays [..., 3] in chunks of `chunk` rays,
    normalised as the production trace is -> TraceOut of shape [...]. The
    dead surfels are left out first: trace_reference accepts no hit of
    theirs, and the alive ones keep their order, so the result is the
    same."""
    from ..ops import grid_tracer as gt
    keep = torch.nonzero(alive).squeeze(1)
    inputs = gt.TraceInputs(*[x[keep] for x in inputs])
    live = torch.ones(keep.shape[0], dtype=torch.bool, device=keep.device)
    shape = ro.shape[:-1]
    fo, fd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    outs = [gt.trace_reference(fo[a:a + chunk], fd[a:a + chunk], inputs,
                               live, sh_deg=sh_deg)
            for a in range(0, fo.shape[0], chunk)]
    out = gt.TraceOut(*[torch.cat(x) for x in zip(*outs)])
    out = gt.normalize_trace(out, transmittance_min)
    return gt.TraceOut(*[x.reshape(shape + x.shape[1:]) for x in out])


def run_module_main(module: str, argv, log_file=None, env=None) -> int:
    """`python -m irgs_tpu_torch.<module> argv` as a call of its main(argv)
    in this process -> its exit code (a SystemExit's, or 1 on an exception,
    whose traceback is printed). With `log_file` (an open file) its output
    goes there; `env`'s DATA_SUBDIR, the one variable the CLIs read, is set
    (or unset) while it runs."""
    name = f"irgs_tpu_torch.{module}"
    mod = importlib.import_module(name)
    if hasattr(mod, "__path__"):            # a package run by its __main__
        mod = importlib.import_module(name + ".__main__")
    old = os.environ.get("DATA_SUBDIR")
    if env is not None:
        if "DATA_SUBDIR" in env:
            os.environ["DATA_SUBDIR"] = env["DATA_SUBDIR"]
        else:
            os.environ.pop("DATA_SUBDIR", None)
    try:
        with contextlib.ExitStack() as out:
            if log_file is not None:
                out.enter_context(contextlib.redirect_stdout(log_file))
                out.enter_context(contextlib.redirect_stderr(log_file))
            try:
                mod.main(argv)
            except SystemExit as e:
                return (e.code if isinstance(e.code, int)
                        else int(e.code is not None))
            except Exception:
                traceback.print_exc()
                return 1
        return 0
    finally:
        if old is None:
            os.environ.pop("DATA_SUBDIR", None)
        else:
            os.environ["DATA_SUBDIR"] = old
