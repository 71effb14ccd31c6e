"""The rank launcher of the tests that hold ProcessGroupBlocks against
LocalBlocks: a job of the port runs on every rank of a gloo process group,
each rank a subprocess of its own (this file run as a script), under one
hard time limit for all of them.

    run_ranks(tmp_path, job, args, world=2) -> [each rank's result]

A rank imports torch, numpy and the port only. Its teardown is ordered so
that no rank's gloo threads outlive its process group:
  * the job's solver, and with it the ProcessGroupBlocks that holds the
    group, is dropped before ``destroy_process_group`` (a group still
    referenced there is destroyed only in interpreter finalization, where a
    native thread that asks for the GIL is ended by ``pthread_exit``, whose
    forced unwind through C++ ends in std::terminate: "terminate called
    without an active exception");
  * a barrier first, so that no rank tears the group down while a peer is
    still in a collective;
  * the process then ends by ``os._exit`` after its result is on disk and
    its output flushed, skipping interpreter finalization altogether.
A failure anywhere still ends the rank with a non-zero exit and its
traceback in the log that the launcher shows.
"""

import datetime
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120        # seconds, for all ranks of a launch together


def run_ranks(tmp_path, job, args, world=2, timeout=RANK_TIMEOUT):
    """Run ``job`` (a key of JOBS) with ``args`` on ``world`` gloo ranks
    (file-store rendezvous in tmp_path); returns each rank's result. The
    ranks are killed when the time limit expires."""
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    store = str(tmp_path / f"{job}.store")
    outs = [str(tmp_path / f"{job}.{r}.npy") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, outs[r], job, repr(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for proc in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(proc.communicate(timeout=left)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * world, f"exit codes {codes}\n" + "\n".join(logs)
    return [np.load(out) for out in outs]


def _fused(blocks, cfg):
    from conservation_fem_tpu_torch.models import kpp
    from conservation_fem_tpu_torch.parallel import ShardedFusedStructured

    p = kpp.build(kpp.KPPConfig(**cfg), device="cpu")
    return ShardedFusedStructured(p, blocks).solve()


def _structured(blocks, model, cfg):
    from conservation_fem_tpu_torch.models import burgers, kpp
    from conservation_fem_tpu_torch.parallel import ShardedStructuredKPP

    if model == "kpp":
        p = kpp.build(kpp.KPPConfig(**cfg), device="cpu")
    else:
        p = burgers.build(burgers.BurgersConfig(**cfg), device="cpu")
    return ShardedStructuredKPP(p, blocks).solve()


def _euler(blocks, cfg):
    from conservation_fem_tpu_torch.models import euler
    from conservation_fem_tpu_torch.parallel import ShardedStructuredEuler

    p = euler.build(euler.EulerConfig(**cfg), device="cpu")
    return ShardedStructuredEuler(p, blocks).solve()


JOBS = {"fused": _fused, "structured": _structured, "euler": _euler}


def _run_job(job, args):
    """The job's result as a numpy array; every object that holds the
    group is gone when this returns."""
    import torch.distributed as dist

    from conservation_fem_tpu_torch.parallel import ProcessGroupBlocks

    return JOBS[job](ProcessGroupBlocks(dist.group.WORLD), *args).numpy()


def _rank_main(argv):
    import torch
    import torch.distributed as dist

    rank, world, store, out, job = (int(argv[0]), int(argv[1]), argv[2],
                                    argv[3], argv[4])
    args = eval(argv[5])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        np.save(out, _run_job(job, args))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    code = 0
    try:
        _rank_main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
