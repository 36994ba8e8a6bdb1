"""Which collectives the gloo backend takes on CUDA tensors, on one card:

    python tools/gloo_cuda_collectives.py [--world 2] [--out FILE]

NCCL refuses two ranks on one device, so the port's multi-rank runs on a
one-card machine use gloo with the tensors left on the card. Each
collective (and each DTensor redistribution the mesh builders rely on) is
tried in a group of its own: ``--world`` spawned processes over a
``file://`` store, the card shared, the result checked against the
expected values. A refused collective can end its processes without a
Python exception (gloo's TCP transport writing a device pointer aborts
the process), so each runs apart and a dead process reads ``crashed``.
``--only`` probes a subset. Prints one JSON object, {name: "ok" | "wrong: ..." | "error: ..." |
"crashed (exit N)" | "timeout"}, beside the torch version and the card;
``--out`` also writes it to a file. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import sys
import tempfile

import torch
import torch.distributed as dist


def _p2p(x, rank, world, dev):
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (rank + 1) % world),
        dist.P2POp(dist.irecv, buf, (rank - 1) % world)])
    for r in reqs:
        r.wait()
    return buf, torch.full_like(x, float((rank - 1) % world + 1))


def _case(name, rank, world, dev):
    """Run collective ``name``; returns (got, want) tensors."""
    x = torch.full((8 * world,), float(rank + 1), device=dev)
    total = float(world * (world + 1) // 2)
    if name == "all_reduce_sum_f32":
        y = x.clone()
        dist.all_reduce(y)
        return y, torch.full_like(x, total)
    if name == "all_reduce_max_f32":
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y, torch.full_like(x, float(world))
    if name == "all_reduce_sum_int32":
        y = x.to(torch.int32)
        dist.all_reduce(y)
        return y, torch.full_like(y, int(total))
    if name == "all_reduce_sum_bf16":
        y = x.to(torch.bfloat16)
        dist.all_reduce(y)
        return y, torch.full_like(y, total)
    if name == "broadcast":
        y = x.clone()
        dist.broadcast(y, src=world - 1)
        return y, torch.full_like(x, float(world))
    if name == "all_gather_into_tensor":
        y = torch.empty(8 * world * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y, torch.arange(1, world + 1, device=dev, dtype=x.dtype) \
            .repeat_interleave(8 * world)
    if name == "reduce_scatter_tensor":
        y = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return y, torch.full_like(y, total)
    if name == "all_to_all_single":
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y, torch.arange(1, world + 1, device=dev, dtype=x.dtype) \
            .repeat_interleave(8)
    if name == "batch_isend_irecv":
        return _p2p(x, rank, world, dev)
    if name == "barrier":
        dist.barrier()
        return x, x
    if name.startswith("funcol_all_reduce"):
        from torch.distributed import _functional_collectives as funcol
        dt = torch.bfloat16 if "bf16" in name else torch.float32
        big = torch.full((1 << 21,), float(rank + 1), device=dev, dtype=dt)
        y = funcol.all_reduce(big, "sum", dist.group.WORLD)
        y = y.wait() if hasattr(y, "wait") else y
        return y, torch.full_like(big, total)
    if name == "funcol_all_gather_tensor":
        from torch.distributed import _functional_collectives as funcol
        y = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        y = y.wait() if hasattr(y, "wait") else y
        return y, torch.arange(1, world + 1, device=dev, dtype=x.dtype) \
            .repeat_interleave(8 * world)
    # DTensor redistributions on a one-axis mesh
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
    t = torch.arange(4.0 * world * world, device=dev).reshape(2 * world,
                                                              2 * world)
    if name == "dtensor_distribute_no_comm":
        d = distribute_tensor(t, mesh, [Shard(0)], src_data_rank=None)
        return d.to_local(), t.chunk(world)[rank]
    if name == "dtensor_shard_to_replicate":
        d = distribute_tensor(t, mesh, [Shard(1)], src_data_rank=None)
        return d.redistribute(mesh, [Replicate()]).to_local(), t
    if name in ("dtensor_shard0_to_replicate", "dtensor_shard1_to_replicate"):
        dim = int(name[len("dtensor_shard")])
        d = DTensor.from_local(t.chunk(world, dim)[rank].contiguous(), mesh,
                               [Shard(dim)])
        return d.redistribute(mesh, [Replicate()]).to_local(), t
    if name == "dtensor_partial_to_replicate_bf16_4mb":
        big = torch.ones(1024, 2048, device=dev, dtype=torch.bfloat16)
        d = DTensor.from_local(big, mesh, [Partial()])
        return d.redistribute(mesh, [Replicate()]).to_local(), big * world
    if name == "dtensor_embedding_vocab_sharded":
        table = torch.arange(64.0, device=dev).reshape(16, 4)
        idx = torch.tensor([[0, 9, 15, 3]], device=dev)
        w = distribute_tensor(table, mesh, [Shard(0)], src_data_rank=None)
        i = distribute_tensor(idx, mesh, [Replicate()], src_data_rank=None)
        out = torch.nn.functional.embedding(i, w)
        return out.redistribute(mesh, [Replicate()]).to_local(), table[idx]
    if name == "dtensor_partial_to_replicate":
        d = DTensor.from_local(t.clone(), mesh, [Partial()])
        return d.redistribute(mesh, [Replicate()]).to_local(), t * world
    if name == "dtensor_partial_to_shard":
        d = DTensor.from_local(t.clone(), mesh, [Partial()])
        return (d.redistribute(mesh, [Shard(0)]).to_local(),
                (t * world).chunk(world)[rank])
    raise KeyError(name)


CASES = ("all_reduce_sum_f32", "all_reduce_max_f32", "all_reduce_sum_int32",
         "all_reduce_sum_bf16", "broadcast", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv",
         "barrier", "funcol_all_reduce_f32_8mb", "funcol_all_reduce_bf16_4mb",
         "funcol_all_gather_tensor", "dtensor_distribute_no_comm",
         "dtensor_shard_to_replicate", "dtensor_shard0_to_replicate",
         "dtensor_shard1_to_replicate", "dtensor_partial_to_replicate",
         "dtensor_partial_to_replicate_bf16_4mb",
         "dtensor_embedding_vocab_sharded", "dtensor_partial_to_shard")


def _child(name, rank, world, store, q):
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        got, want = _case(name, rank, world, dev)
        torch.cuda.synchronize()
        ok = got.device.type == "cuda" and torch.equal(got.float().cpu(),
                                                       want.float().cpu())
        q.put((rank, "ok" if ok else f"wrong: {got.flatten()[:4].tolist()}"))
    except Exception as e:                       # a refusal, reported
        q.put((rank, f"error: {type(e).__name__}: {str(e)[:120]}"))
    dist.destroy_process_group()


def probe(name, world, timeout=60.0):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    store = f"file://{tmp}/store"
    procs = [ctx.Process(target=_child, args=(name, r, world, store, q))
             for r in range(world)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < world:
            try:
                r, v = q.get(timeout=timeout)
            except queue.Empty:
                break
            res[r] = v
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    if len(res) < world:
        codes = [p.exitcode for p in procs]
        dead = [c for c in codes if c not in (0, None)]
        return f"crashed (exit {dead[0]})" if dead else "timeout"
    vals = set(res.values())
    return vals.pop() if len(vals) == 1 else json.dumps(res)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None, choices=CASES,
                    help="probe these cases only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_collectives: no CUDA device")
    out = {name: probe(name, args.world) for name in (args.only or CASES)}
    line = json.dumps({"torch": torch.__version__,
                       "card": torch.cuda.get_device_name(0),
                       "world": args.world, "gloo_on_cuda": out})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
