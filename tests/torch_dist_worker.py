"""One process of the two-process gloo run of the port's sharded BA
(tests/test_torch_dist_ba.py::test_two_process_gloo): joins the group,
partitions the problem of tests/dist/test_dist_ba.py into 2 x world
shards, solves its block of 2 shards with (S, b) and the cost
all-reduced over the group, and writes its poses and costs.

Usage: python tests/torch_dist_worker.py <rank> <world> <host:port> <out_dir>
"""

import os
import sys


def main():
    rank, world, coord, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import datetime

    import numpy as np
    import torch

    torch.set_num_threads(2)
    from spslam_tpu_torch.geometry.camera import Intrinsics
    from spslam_tpu_torch.parallel import dist_ba as td

    torch.distributed.init_process_group("gloo", init_method=f"tcp://{coord}",
                                         world_size=world, rank=rank,
                                         timeout=datetime.timedelta(seconds=120))
    assert td.init_distributed()       # already up: True without a second init
    # the same seeded problem in every process (make_problem is numpy +
    # the JAX package's geometry, like the test that compares against it)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.dist.test_dist_ba import INTR
    from tests.test_torch_dist_ba import make_problem

    (poses_init, fixed, pts_init, oc, op, ouv, our, _, _) = make_problem(n_cams=5, n_pts=256)
    D = 2 * world
    prob = td.partition_problem(poses_init, fixed, pts_init, oc, op, ouv, our,
                                np.ones(len(oc), np.float32), D)
    mine = td.local_shards(prob, rank, world)
    stats = {}
    _, _, cost0 = td.dist_bundle_adjust(mine, Intrinsics(*INTR), ["cpu"] * 2, n_iters=0)
    poses, _, cost = td.dist_bundle_adjust(mine, Intrinsics(*INTR), ["cpu"] * 2, n_iters=6,
                                           stats=stats)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), poses=poses.numpy(),
             cost0=float(cost0), cost=float(cost), reduce_calls=stats["all_reduce_calls"])
    torch.distributed.destroy_process_group()
    print(f"MP_OK rank={rank} cost {float(cost0):.1f} -> {float(cost):.1f}", flush=True)


if __name__ == "__main__":
    main()
