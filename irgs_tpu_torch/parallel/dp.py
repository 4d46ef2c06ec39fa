"""Multi-device parallelism on torch.distributed (≙ irgs_tpu/parallel/dp.py).

The JAX package runs one process over a device mesh (shard_map). The torch
idiom is one process per device, joined into a process group; the names here
are the reference's, so that each counterpart is easy to find:

* **Training**: data-parallel over cameras. Every rank holds the same
  parameters (broadcast from rank 0 once, at set-up), runs the full stage-2
  forward and backward for its own camera, averages the gradients and the
  metrics over the ranks with one all_reduce of a flat buffer (≙ pmean) and
  takes the same optimizer step, so the parameters stay equal bit for bit.
* **Eval**: the Monte-Carlo sample axis shards over the ranks: each traces
  1/D of every pixel's incident samples and the partial means are averaged
  (`eval_mc_sharded`, and `rendering_equation(shard=)`).

`spawn_ranks` starts the ranks of a command: one process per rank with the
`spawn` start method, joined through a `file://` store in a temporary
directory (no TCP port to collide), each collective and each join under a
timeout, so that a rank that dies is an error and not a hang.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

# seconds a collective (and the process group's set-up) may wait for the
# other ranks before it raises
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a process group (≙ a one-axis
    jax.sharding.Mesh): its `rank` among `size` ranks of `group` (None: the
    default group)."""
    rank: int
    size: int
    group: object = None

    def pmean(self, tensors):
        """The mean over the ranks of each float32 tensor (≙ jax.lax.pmean):
        one all_reduce of their flat concatenation, then a division by the
        size. Returns new tensors."""
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("pmean: float32 tensors only")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat = flat / self.size
        return [x.view(t.shape) for x, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)]


def make_mesh(n_devices: int, *, rank: int, backend: str,
              init_method: str) -> Mesh:
    """Join this process to a process group of `n_devices` ranks as `rank`
    (≙ make_mesh): `backend` "nccl" for ranks that each own a card, "gloo"
    for CPU processes or ranks that share a card; `init_method` the
    rendezvous, e.g. "file:///tmp/x/init"."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_devices, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(rank=rank, size=n_devices, group=dist.group.WORLD)


@torch.no_grad()
def broadcast_params(mesh: Mesh, params) -> None:
    """Rank 0's parameter values to every rank, in place."""
    for t in params.tensors().values():
        dist.broadcast(t.detach(), src=0, group=mesh.group)


def stage2_dp_step(mesh: Mesh, st):
    """The data-parallel stage-2 step (≙ stage2_dp_step, :40-73):
    step(state, grid, cam, gt_image, draws) -> (state, metrics), where cam,
    gt_image and draws are this rank's. Each rank runs stage2_forward_loss
    with no mask (as the reference's shard-mapped step, which passes None),
    the gradients and metrics are averaged over the ranks in one all_reduce
    (a gradient that no rank has stays None, as torch leaves it; a rank
    without one where another has it counts zeros, as JAX's dense
    gradients), and every rank takes the optimizer step. The state's
    parameters must be equal on every rank (broadcast_params)."""
    from ..train import stage2 as s2

    def step(state, grid, cam, gt_image, draws):
        state.optimizer.zero_grad()
        loss, metrics = s2.stage2_forward_loss(
            state.params, state.aux, grid, cam, gt_image, None, draws,
            state.step, st)
        loss.backward()
        params = list(state.params.tensors().values())
        names = sorted(metrics)
        dev = params[0].device
        has = torch.tensor([float(p.grad is not None) for p in params],
                           device=dev)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        vals = [metrics[k].detach().to(torch.float32) for k in names]
        mean = mesh.pmean(grads + [has] + vals)
        any_has = mean[len(params)].tolist()
        for p, g, h in zip(params, mean, any_has):
            p.grad = g if h > 0 else None
        state.optimizer.step(state.step)
        state.step += 1
        return state, dict(zip(names, mean[len(params) + 1:]))

    return step


def eval_mc_sharded(mesh: Mesh, shade_fn):
    """Wrap a per-pixel MC shading fn so that its sample axis shards over
    the ranks (≙ eval_mc_sharded, :76-91): shade_fn(pixels, key) -> dict of
    per-pixel estimates over this rank's samples; the wrapped
    fn(pixels, keys) shades with keys[rank] and averages every output over
    the ranks, which is the estimator over all their samples."""
    def sharded(pixels, keys):
        out = shade_fn(pixels, keys[mesh.rank])
        names = list(out)
        return dict(zip(names, mesh.pmean([out[k] for k in names])))
    return sharded


def _rank_main(rank, fn, devices, backend, init_method, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_mesh(len(devices), rank=rank, backend=backend,
                     init_method=init_method)
    try:
        fn(mesh, device, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, devices, backend: str, args=()) -> None:
    """Run fn(mesh, device, *args) in one spawned process per entry of
    `devices` (rank r on devices[r]), joined as a process group with
    `backend` through a file store in a temporary directory. Returns when
    every rank has finished; raises (torch.multiprocessing's
    ProcessRaisedException or ProcessExitedException) as soon as one fails,
    after stopping the others. `fn` must be importable (a module-level
    function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="irgs_dist_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, list(devices), backend, init, tuple(args)),
            nprocs=len(devices), join=False, start_method="spawn")
        try:
            # each join returns after a second, or raises when a rank failed
            while not ctx.join(timeout=1.0):
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)


def launch_ranks(fn, n_devices: int, device: str, args=()) -> None:
    """Run a command's `n_devices` ranks of fn(mesh, device, *args)
    (≙ the JAX CLIs' mesh of `--n_devices`): on cuda one rank per visible
    card over NCCL (fewer visible cards raise SystemExit, as train.py does),
    on the CPU that many gloo processes. A rank's exit code becomes the
    launcher's."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    if dev.type == "cuda":
        n_vis = torch.cuda.device_count()
        if n_vis < n_devices:
            raise SystemExit(f"--n_devices {n_devices} but only {n_vis} CUDA "
                             "devices visible; use --device cpu for CPU ranks")
        devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
    elif dev.type == "cpu":
        devices, backend = ["cpu"] * n_devices, "gloo"
    else:
        raise ValueError(f"--n_devices: unsupported device {device}")
    try:
        spawn_ranks(fn, devices, backend, args)
    except mp.ProcessExitedException as e:
        raise SystemExit(e.exit_code) from e
