"""The port's mesh and process-group plumbing (``distributed.py``):

  * standalone, nothing configured: ``init_process_group()`` is False,
    the keys axis has size 1, and a batch checked under
    ``keys_sharding`` gives the host oracle's verdicts (the JAX
    package's ``test_distributed_standalone_degrades``); a partial
    cluster configuration raises;
  * a two-process ``gloo`` group on the CPU, two CPU shards per
    process: each rank checks its block of 8 keys and returns the whole
    list, which equals the list one process gives over the same shards.

Module-level imports are torch and the port only: the spawned workers
import this module, and never need jax."""

import json
import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

from jepsen_tpu_torch import distributed as dist
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.checker import seq as tseq
from jepsen_tpu_torch.history import encode_ops


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(n=8):
    """The reference's standalone case: 24-op cas-register keys, every
    other one corrupted."""
    import random

    model = tm.cas_register()
    seqs = []
    for k in range(n):
        rng = random.Random(4200 + k)
        h = ts.register_history(rng, n_ops=24, n_procs=3, overlap=3)
        if k % 2 == 0:
            h = ts.corrupt_read(rng, h, at=0.7)
        seqs.append(encode_ops(h, model.f_codes))
    return seqs, model


def _summary(results):
    return [[r["valid"], r["configs"], r.get("max_depth"), r["engine"]]
            for r in results]


def test_standalone_degrades():
    assert dist.init_process_group() is False
    assert not dist.is_initialized()
    info = dist.process_info(devices=["cpu"] * 8)
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 8, "global_devices": 8}
    mesh = dist.multihost_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"keys": 1, "shard": 8}
    sh = dist.keys_sharding(mesh)
    assert sh.n_processes == 1 and sh.num_devices == 8
    seqs, model = _keys()
    want = [tseq.check_opseq(s, model)["valid"] for s in seqs]
    got = tlin.search_batch(seqs, model, budget=100_000, sharding=sh)
    assert [r["valid"] for r in got] == want


def test_keys_sharding_over_the_shard_axis_is_the_mesh():
    """A sharding over the shard axis of a one-process mesh, a keys axis
    of size 1, and the bare mesh give the same results."""
    seqs, model = _keys()
    mesh = dist.ShardMesh(["cpu"] * 3)
    want = _summary(tlin.search_batch(seqs, model, budget=100_000,
                                      bucket=False, sharding=mesh))
    for sh in (dist.keys_sharding(mesh, "shard"),
               dist.keys_sharding(dist.multihost_mesh(devices=["cpu"] * 3))):
        assert _summary(tlin.search_batch(seqs, model, budget=100_000,
                                          bucket=False, sharding=sh)) == want


def test_partial_cluster_configuration_raises():
    with pytest.raises(ValueError, match="partial cluster"):
        dist.init_process_group(coordinator="127.0.0.1:1",
                                num_processes=2)
    with pytest.raises(ValueError, match="not in the mesh"):
        dist.keys_sharding(dist.ShardMesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="mixed device types"):
        dist.ShardMesh(["cpu", "meta"])


def _worker(rank, port, out_dir):
    """One process of the two-process run: its block of the keys over
    two CPU shards, gathered over the group."""
    torch.set_num_threads(1)
    assert dist.init_process_group(coordinator=f"127.0.0.1:{port}",
                                   num_processes=2, process_id=rank,
                                   device="cpu", timeout=60.0)
    try:
        mesh = dist.multihost_mesh(devices=["cpu", "cpu"])
        assert mesh.shape == {"keys": 2, "shard": 2}
        info = dist.process_info(devices=mesh.devices)
        seqs, model = _keys()
        res = tlin.search_batch(seqs, model, budget=100_000,
                                sharding=dist.keys_sharding(mesh))
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump({"info": info, "results": _summary(res)}, f)
    finally:
        dist.shutdown_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_equals_one_process(tmp_path):
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the workers hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    seqs, model = _keys()
    want = _summary(tlin.search_batch(
        seqs, model, budget=100_000,
        sharding=dist.ShardMesh(["cpu", "cpu"])))
    assert any(w[3] == "device-batch" for w in want)
    for rank in range(2):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got["info"] == {"process_index": rank, "process_count": 2,
                               "local_devices": 2, "global_devices": 4}
        assert got["results"] == want, rank
