"""One rank of the port's multi-process CPU runs (tests/test_torch_dist.py).

Usage: python _torch_dist_worker.py <rank> <world> <json config>

The process refuses `longreadmapper_tpu` and `jax` at import, as the
port's import rule asks.  With config["store"] set, the worker forms the
Gloo group itself over that FileStore (a group the caller made, which
init_distributed leaves alone); else init_distributed forms it from the
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK environment.  Modes:

  map   — runtime/launch.run_distributed on the CPU (config: fa, fq,
          prefix, chunk_b, shard, model_shards, slim); optionally the
          gact path forced on bucket `force_gact` (a zero resident budget,
          tests/test_torch_long.py::_force_gact) and overflow bit 1 set on
          every submitted part (`force_sat`).  Prints WORKER_OK with the
          global (valid, total), the saturation retries and the device
          bytes of each index table.
  rows  — ShardedRows over a model group of every rank, against the plain
          gather of the whole table (prints ROWS_OK).
  hang  — rank 0 waits in an all_reduce that rank 1 never joins; rank 0
          must fail within the mesh group's timeout (config timeout_s).
          The default group forms with the rendezvous timeout (120 s, in
          every mode) and the ranks meet at a barrier before the mesh
          forms, so a rank that starts late is not taken for the hung one.
"""

import importlib.abc
import json
import os
import sys
import time


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("longreadmapper_tpu", "jax", "jaxlib"):
            raise ModuleNotFoundError(f"refused: {name}")
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import datetime  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
cfg = json.loads(sys.argv[3])
# the rendezvous timeout; the hang mode's timeout_s bounds only the mesh
# group it hangs in
timeout = datetime.timedelta(seconds=120)
if cfg.get("store"):
    dist.init_process_group("gloo", store=dist.FileStore(cfg["store"], world),
                            rank=rank, world_size=world, timeout=timeout)


def run_map():
    from dataclasses import replace

    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.runtime.launch import run_distributed
    from longreadmapper_tpu_torch.utils.config import Params

    mappers = []
    init = TorchMapper.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        mappers.append(self)

    TorchMapper.__init__ = record
    if cfg.get("force_gact"):
        step_for = TorchMapper._step_for

        def gact_step_for(self, L):
            cfg_L = step_for(self, L)
            if L == cfg["force_gact"] and cfg_L.mid_dirs_budget:
                cfg_L = self._cfgs[L] = replace(cfg_L, mid_dirs_budget=0)
            return cfg_L

        TorchMapper._step_for = gact_step_for
    if cfg.get("force_sat"):
        dispatch = TorchMapper._dispatch_chunk

        def saturated(self, prepared, *a):
            parts = dispatch(self, prepared, *a)
            for p in parts:
                mb = 4 * p.cfg.meta_words
                meta = p.first.blob[:, :mb].contiguous().view(torch.int32)
                meta[:, -1] |= 2
                p.first.blob[:, :mb] = meta.view(torch.int8)
            return parts

        TorchMapper._dispatch_chunk = saturated

    params = Params(hlen=6, seed_len=20, thres=300, batch_size=64)
    valid, total = run_distributed(
        cfg["fa"], cfg["fq"], params, out_prefix=cfg["prefix"], rg_id=0,
        chunk_b=cfg["chunk_b"], shard_index_tables=cfg.get("shard", False),
        model_shards=cfg.get("model_shards", 0), slim=cfg.get("slim", False),
        verbose=False, device="cpu")
    m = mappers[0]
    tables = {k: [getattr(m.idx, k).nbytes, list(getattr(m.idx, k).shape)]
              for k in ("sa_ctx", "sa_hi", "lch", "lch_hi", "text_packed",
                        "text_pair") if getattr(m.idx, k) is not None}
    print("WORKER_OK " + json.dumps(dict(
        rank=rank, valid=valid, total=total,
        sat=m.retried_sat_chunks, retried=m.retried_reads,
        tables=tables)), flush=True)


def run_rows():
    """Every rank is one model shard; gathers at the shard edges, at the
    clamped last row and past it, for int32, uint8 and (n, 2) rows."""
    from longreadmapper_tpu_torch.parallel.dist import ShardedRows
    from longreadmapper_tpu_torch.parallel.mesh import make_mesh
    from longreadmapper_tpu_torch.runtime.launch import init_distributed

    init_distributed("cpu")
    mesh = make_mesh(1, world, "cpu")
    m = mesh.get_coordinate()[1]
    rng = np.random.default_rng(5)
    checked = {}
    for name, n, shape, dtype in (("i32", 37, (), np.int32),
                                  ("u8", 37, (), np.uint8),
                                  ("pair", 41, (2,), np.int32)):
        info = np.iinfo(dtype)
        host = rng.integers(info.min, info.max, (n,) + shape,
                            dtype=np.int64).astype(dtype)
        t = ShardedRows(host, m, world, mesh.get_group("model"), "cpu")
        R = -(-n // world)
        edges = [0, R - 1, R, 2 * R - 1, n - 1]
        idx = torch.tensor([[e, n - 1 - e] for e in edges] + [[n, n + 5]],
                           dtype=torch.int64)
        clamped = idx.clamp(0, t.shape[0] - 1)
        got = t[clamped]
        want = torch.from_numpy(host)[clamped]
        past = t[idx[-1:]]                    # unclamped: zero pad rows
        assert got.dtype == want.dtype and torch.equal(got, want), name
        assert torch.equal(past, torch.zeros_like(past)), name
        assert t.shape == host.shape and t.dtype == want.dtype, name
        assert t.nbytes == R * host[0:1].nbytes, (name, t.nbytes)
        checked[name] = [t.nbytes, list(t.shape)]
    print("ROWS_OK " + json.dumps(dict(rank=rank, tables=checked)),
          flush=True)


def run_hang():
    from longreadmapper_tpu_torch.parallel.mesh import make_mesh
    from longreadmapper_tpu_torch.runtime.launch import init_distributed

    init_distributed("cpu")
    dist.barrier()                 # both ranks up before the clock starts
    mesh = make_mesh(world, 1, "cpu", timeout_s=cfg["timeout_s"])
    if rank:
        time.sleep(cfg["sleep_s"])
        return
    t0 = time.perf_counter()
    try:
        dist.all_reduce(torch.ones(1), group=mesh.get_group("data"))
    except RuntimeError as e:
        print(f"HANG_FAILED after {time.perf_counter() - t0:.1f} s: "
              f"{str(e)[:80]}", flush=True)
        # leave without tearing down a group whose collective timed out:
        # Gloo's teardown can abort the process there
        os._exit(3)
    print("HANG_PASSED", flush=True)


{"map": run_map, "rows": run_rows, "hang": run_hang}[cfg["mode"]]()
if cfg["mode"] != "hang" and dist.is_initialized():
    # leave together: a rank whose peer has gone aborts in Gloo's teardown
    dist.barrier()
    dist.destroy_process_group()
