"""The local mapper's bundle adjustment replayed as one CUDA graph.

At the local mapper's shape (M 24, P 4,096, R 16,384, L 16, Q 64, E 32;
4 + 6 LM iterations) one `bundle_adjust` is ~20,000 small device
operations (19,897 under the profiler on an H100, ~52 ms of device time),
and launching them one by one holds the mapping worker on a CPU for
0.5-1.6 s a call, the more the busier the tracker.  The solve is already
fit for capture: `MapperConfig` pads every shape, the LM accepts or
rejects by `torch.where` and `cho_solve` never syncs.  So it goes through
`cuda_graphs.CapturedCalls` (spans `mapper.ba_replay`, `mapper.ba_capture`)
and only the launches change.  On the CPU the solve stays eager, and the
post-loop global BA (its shape changes with every closure) calls
`bundle_adjust` itself.
"""

from __future__ import annotations

import torch

from ..cuda_graphs import CapturedCalls
from ..solver.ba import BAProblem, BAResult, bundle_adjust

# the process's one cache (a System is built per session, several may share
# a process): every LocalMapper solves through it
GRAPHS = CapturedCalls("mapper.ba")


def problem_dims(prob: BAProblem) -> tuple:
    """(M, P, R, OMAX, L, Q, E) of a problem."""
    return (prob.poses.shape[0], prob.points.shape[0], prob.obs_cam.shape[0],
            prob.pt_obs.shape[1], prob.planes.shape[0], prob.pobs_cam.shape[0],
            prob.pp_a.shape[0])


def mapper_dims(cfg) -> tuple:
    """(M, P, R, OMAX, L, Q, E) that `LocalMapper._host_problem` pads to
    under the MapperConfig `cfg`."""
    return (cfg.ba_max_poses, cfg.ba_max_points, cfg.ba_max_obs, cfg.ba_obs_per_point,
            cfg.ba_max_planes, cfg.ba_max_plane_obs, cfg.ba_max_pp_edges)


def to_device(prob: BAProblem, device) -> BAProblem:
    return BAProblem(*(x.to(device) for x in prob))


def fetch(res: BAResult) -> tuple:
    """(poses, points, planes, obs_inlier) as numpy arrays: what the mapper
    writes back."""
    return tuple(x.cpu().numpy() for x in (res.poses, res.points, res.planes, res.obs_inlier))


def key(prob: BAProblem, intr, cfg, device):
    """The cache key of a local BA, or None where it stays eager: off a
    CUDA device, or at another shape than the local mapper's.  `intr`'s
    floats are constants of the captured kernels."""
    device = torch.device(device)
    if device.type != "cuda" or problem_dims(prob) != mapper_dims(cfg):
        return None
    return (str(device), tuple((tuple(x.shape), x.dtype) for x in prob), intr,
            cfg.ba_stage1_iters, cfg.ba_stage2_iters)


def build(intr, cfg):
    """The `build` that `CapturedCalls.run` takes: `bundle_adjust` on the
    problem's tensors."""
    def call_on(tensors):
        prob = BAProblem(*tensors)
        return lambda: bundle_adjust(prob, intr, cfg.ba_stage1_iters, cfg.ba_stage2_iters)
    return call_on


def solve(prob: BAProblem, intr, cfg, device, graphs: CapturedCalls = GRAPHS) -> tuple:
    """`fetch` of `bundle_adjust(prob)` for the host problem `prob` built
    under the MapperConfig `cfg`, solved on `device` through `graphs`."""
    return graphs.run(key(prob, intr, cfg, device), device, prob, build(intr, cfg), fetch)
