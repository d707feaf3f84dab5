"""Which gloo calls take CUDA tensors: a probe of ranks that share one card.

    python -m quantizedmha_tpu_torch.harness.gloo_probe [--ranks 2] [--json out.json]

Spawns `--ranks` processes on GPU 0, joined by a gloo group through a
FileStore in a temporary directory, and tries each call the tensor- and
context-parallel paths issue on CUDA tensors: all_reduce (bf16, f32),
broadcast, batch_isend_irecv and all_gather (list and into one tensor). Each
call runs in its own spawn of the ranks (a gloo call that takes a CUDA
pointer it cannot handle aborts the process) and is checked for its bytes,
not only for raising. Then one spawn times an all_reduce at decode's and
prefill's rows of a Llama-3-8B hidden row, and a ring step's rotation staged
through host buffers. Prints one JSON object (and writes it to --json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback


def _check(name, fn, out):
    try:
        ok = bool(fn())
        out[name] = {"ok": ok} if ok else {"ok": False, "error": "wrong bytes"}
    except Exception as e:  # noqa: BLE001 -- the probe records what each call raises
        out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}


CALLS = ("all_reduce_cuda_bf16", "all_reduce_cuda_f32", "broadcast_cuda_bf16",
         "batch_isend_irecv_cpu", "batch_isend_irecv_cuda", "all_gather_cuda",
         "all_gather_into_tensor_cuda", "times")


TIMEOUT_S = 90


def _rank_main(rank, world, store, path, call):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    res = {}
    right, left = (rank + 1) % world, (rank - 1) % world

    def val(r, dtype, n=4096):
        return torch.arange(n, device=dev, dtype=torch.float32).mul(0.001).add(r).to(dtype)

    def all_reduce(dtype):
        x = val(rank, dtype)
        dist.all_reduce(x)
        want = sum(val(r, torch.float32) for r in range(world))
        return torch.allclose(x.float(), want, rtol=2e-2 if dtype == torch.bfloat16 else 1e-6)

    def broadcast():
        x = val(rank, torch.bfloat16)
        dist.broadcast(x, src=0)
        return torch.equal(x, val(0, torch.bfloat16))

    def p2p(device):
        send = [val(rank, torch.bfloat16).to(device), val(rank + 10, torch.bfloat16).to(device)]
        recv = [torch.empty_like(t) for t in send]
        ops = ([dist.P2POp(dist.isend, t, right, None, i) for i, t in enumerate(send)]
               + [dist.P2POp(dist.irecv, t, left, None, i) for i, t in enumerate(recv)])
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return (torch.equal(recv[0].cpu(), val(left, torch.bfloat16).cpu())
                and torch.equal(recv[1].cpu(), val(left + 10, torch.bfloat16).cpu()))

    def all_gather():
        parts = [torch.empty(4096, device=dev, dtype=torch.bfloat16) for _ in range(world)]
        dist.all_gather(parts, val(rank, torch.bfloat16))
        return all(torch.equal(p, val(r, torch.bfloat16)) for r, p in enumerate(parts))

    def all_gather_into():
        out = torch.empty(world * 4096, device=dev, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, val(rank, torch.bfloat16))
        return torch.equal(out, torch.cat([val(r, torch.bfloat16) for r in range(world)]))

    checks = {"all_reduce_cuda_bf16": lambda: all_reduce(torch.bfloat16),
              "all_reduce_cuda_f32": lambda: all_reduce(torch.float32),
              "broadcast_cuda_bf16": broadcast,
              "batch_isend_irecv_cpu": lambda: p2p("cpu"),
              "batch_isend_irecv_cuda": lambda: p2p(dev),
              "all_gather_cuda": all_gather,
              "all_gather_into_tensor_cuda": all_gather_into}
    if call != "times":
        _check(call, checks[call], res)
        _finish(rank, world, res, path)
        return
    times = {}
    for rows in (8, 256, 2048):
        x = torch.randn(rows, 4096, device=dev).to(torch.bfloat16)
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.barrier()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        times[f"all_reduce_bf16_{rows}x4096_ms"] = (time.perf_counter() - t0) * 1e3 / n
    # A ring step's K/V rotation at the CP prefill's shard (8 kv heads x
    # 2048 rows x 128, bf16), staged through host buffers.
    kv = [torch.randn(1, 8, 2048, 128, device=dev).to(torch.bfloat16) for _ in range(2)]
    dist.barrier()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        host = [t.cpu() for t in kv]
        recv = [torch.empty_like(t) for t in host]
        ops = ([dist.P2POp(dist.isend, t, right, None, i) for i, t in enumerate(host)]
               + [dist.P2POp(dist.irecv, t, left, None, i) for i, t in enumerate(recv)])
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        kv = [t.to(dev) for t in recv]
    torch.cuda.synchronize()
    times["ring_step_staged_2x4MiB_ms"] = (time.perf_counter() - t0) * 1e3 / n
    res["times"] = times
    _finish(rank, world, res, path)


def _finish(rank, world, res, path):
    import torch.distributed as dist

    with open(f"{path}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def probe(ranks: int) -> dict:
    import torch
    import torch.multiprocessing as mp

    calls, times = {}, None
    for call in CALLS:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "probe.json")
            ctx = mp.start_processes(_rank_main,
                                     args=(ranks, os.path.join(d, "store"), path, call),
                                     nprocs=ranks, join=False, start_method="spawn")
            deadline = time.monotonic() + TIMEOUT_S
            try:
                while not ctx.join(timeout=1):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"a rank hung past {TIMEOUT_S} s")
            except (mp.ProcessException, TimeoutError) as e:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                calls[call] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
                continue
            per_rank = []
            for r in range(ranks):
                with open(f"{path}.{r}") as f:
                    per_rank.append(json.load(f))
        if call == "times":
            times = [r["times"] for r in per_rank]
            continue
        bad = [r[call] for r in per_rank if not r[call]["ok"]]
        calls[call] = bad[0] if bad else per_rank[0][call]
    return {"ranks": ranks, "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "card": torch.cuda.get_device_name(0),
            "calls": calls, "times_rank": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        out = probe(args.ranks)
    except Exception:  # noqa: BLE001 -- report the failure, exit non-zero
        traceback.print_exc()
        return 1
    from quantizedmha_tpu_torch.profiling.device_info import power_limit
    out["gpu"] = power_limit(0)
    text = json.dumps(out)
    print(text, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
