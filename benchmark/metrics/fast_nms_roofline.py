"""Kernel B1's share of its roofline: the least time of one launch on the
frames the window handed in (benchmark/b1_count.py: the bytes, and the
operations these frames need, on the published peaks), averaged over the
frames, over the launches' mean device time in the trace."""

import torch

from benchmark import b1_count
from benchmark.reference.pyramid import PyramidSpec


def read(obs):
    times = [e - s for n, s, e in obs.trace.events if b1_count.KERNEL_NAME in n]
    if not times or not obs.frames:
        return None
    c, t = obs.config["camera"], obs.config["tracker"]
    spec = PyramidSpec(t["n_levels"], t["scale_factor"], c["height"], c["width"])
    bounds = [b1_count.bound_s(b1_count.work(
        spec.level_sizes, ring_px=b1_count.ring_px(torch.from_numpy(g).to(obs.device), spec,
                                                   t["th_fast_low"])))
        for g in obs.frames]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times) * 1e-9)
