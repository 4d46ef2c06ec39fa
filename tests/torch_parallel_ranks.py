"""The ranks of tests/test_torch_parallel.py's two-rank gloo world, in a
module of their own: the spawned processes import it, and it imports only
the port (never JAX), numpy and torch."""

import os

import numpy as np
import torch

from irgs_tpu_torch.config import Config
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.parallel import broadcast_params, eval_mc_sharded, stage2_dp_step
from irgs_tpu_torch.render.eval import EvalConfig, render_ir_eval
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy
from irgs_tpu_torch.train import stage2 as s2

# tests/test_parallel.py's scale
TRACER = dict(grid_res=16, pair_capacity=2 ** 14, max_cells=8, max_hits=16,
              hit_budget=8)
STATIC = dict(img_w=32, img_h=32, active_sh_degree=1, diffuse_sample_num=8,
              light_sample_num=0, trace_num_rays=256, light_t_min=0.05,
              wo_indirect=False, detach_indirect=False,
              white_background=False, dup_capacity=2 ** 12)
STEP = 1001            # > normal_loss_start: every loss term has gradients
# the sample-sharded frames: (diffuse, light samples, compact_fg)
FRAMES = ((16, 8, False), (16, 8, True), (16, 0, True))
MC_KEYS = (10, 11)


def static():
    return s2.Stage2Static(**STATIC, tracer=tgt.TracerConfig(**TRACER))


def gt_image(rank):
    return torch.full((32, 32, 3), 0.25 + 0.05 * rank)


def mc_shade(pixels, key):
    """A per-device MC estimate over its own sample subset
    (tests/test_parallel.py:97-100), drawn from a generator seeded by key."""
    s = torch.rand((pixels.shape[0], 4),
                   generator=torch.Generator().manual_seed(key))
    return {"radiance": (pixels[:, None] * s).mean(dim=1)}


def _state(inp):
    params, aux = tgs.params_from_numpy(
        {f: inp[f] for f in tgs.PARAM_FIELDS}, inp["alive"], "cpu")
    state = s2.init_state(params, aux, Config().opt)
    state.step = STEP
    return state


def _draws(inp, rank):
    return s2.Stage2Draws(pixel_u=torch.tensor(inp[f"pixel_u{rank}"]),
                          theta_u=torch.tensor(inp[f"theta_u{rank}"]))


def _numpy_params(state):
    return {f: t.detach().numpy().copy()
            for f, t in state.params.tensors().items()}


def world_rank(mesh, device, inputs, out_dir):
    """Everything the test checks at world size 2: the DP step from the
    JAX package's parameters and draws; on rank 0 also the single-process
    mean step; eval_mc_sharded; and the sample-sharded frames, with rank 0
    rendering the one-rank frames beside them."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs))
    st = static()
    cams = toy.make_ring_cameras(8, width=32, height_px=32)
    out = {}

    state = _state(inp)
    broadcast_params(mesh, state.params)
    grid = tgt.build_grid_from_gaussians(state.params, state.aux, st.tracer)
    step = stage2_dp_step(mesh, st)
    r = mesh.rank
    state, metrics = step(state, grid, cams[r].params("cpu"), gt_image(r),
                          _draws(inp, r))
    out.update({f"dp_{k}": v for k, v in _numpy_params(state).items()})
    out.update({f"metric_{k}": float(v) for k, v in metrics.items()})

    if r == 0:
        # one process: the mean of the two ranks' gradients, one Adam step
        ref = _state(inp)
        sums, losses = {}, []
        for q in range(mesh.size):
            ref.optimizer.zero_grad()
            loss, _ = s2.stage2_forward_loss(
                ref.params, ref.aux, grid, cams[q].params("cpu"), gt_image(q),
                None, _draws(inp, q), ref.step, st)
            loss.backward()
            losses.append(float(loss))
            for f, t in ref.params.tensors().items():
                if t.grad is not None:
                    sums[f] = t.grad.clone() if f not in sums else sums[f] + t.grad
        for f, t in ref.params.tensors().items():
            t.grad = sums[f] / mesh.size if f in sums else None
        ref.optimizer.step(ref.step)
        out.update({f"mean_{k}": v for k, v in _numpy_params(ref).items()})
        out["mean_losses"] = np.array(losses)

    pixels = torch.linspace(0.0, 1.0, 16)
    out["mc_sharded"] = eval_mc_sharded(mesh, mc_shade)(
        pixels, MC_KEYS)["radiance"].numpy()

    params, aux = tgs.params_from_numpy(
        {f: inp[f] for f in tgs.PARAM_FIELDS}, inp["alive"], "cpu")
    cam = cams[0].params("cpu")
    for d, l, compact in FRAMES:
        ecfg = EvalConfig(img_w=32, img_h=32, active_sh_degree=1,
                          diffuse_sample_num=d, light_sample_num=l,
                          dup_capacity=2 ** 12,
                          tracer=tgt.TracerConfig(**TRACER))
        egrid = tgt.build_grid_from_gaussians(params, aux, ecfg.tracer)
        runs = [("sharded", mesh)] + ([("single", None)] if r == 0 else [])
        for name, m in runs:
            frame = render_ir_eval(params, aux, egrid, cam, ecfg, mesh=m,
                                   compact_fg=compact)
            for k, v in frame.items():
                out[f"{name}_{d}_{l}_{compact}_{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)
