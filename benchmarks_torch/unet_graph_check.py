#!/usr/bin/env python3
"""The piecewise CUDA graphs of the UNet forward (`diffusion/unet_graph.py`)
against the eager forward on the card, at the benchmark cells' keys.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/unet_graph_check.py --out build/unet_graph_check.json

SDXL's base UNet (with the IP-Adapter K/V) and refiner at their published
widths, random weights in bf16, 1024² latents, 77 text tokens, 4 IP tokens;
the keys the cells run: the inversion (base, no guidance) at 1 and 4 rows,
the IP denoise (guidance 10) at 2 and 8 rows, the refiner (guidance 10) at
2 and 8 rows. For each key, one `make_cfg_eps_fn` loop called on one input:

1. The first call runs eagerly (a key's first sight), the second captures
   and replays, the third replays. ε of the replays against the eager ε:
   the same kernels on the same inputs, so the check fails unless they are
   bit-identical (max |difference| recorded). K1 launches per forward
   (`flash_fwd_cuda.launches`).
2. Device ops per forward in a `torch.profiler` trace, eager against a
   replay (memory copies and sets counted apart), and the kernel names whose
   counts differ: equal counts, less the replay's copy of ε out of the pool,
   say the profiler sees the kernels a graph launches. The IP scale's
   product differs by name (a Python scalar's kernel eager, a device
   scalar's in the graph: the same arithmetic).
3. Capture seconds (the second call, synced) and the device memory it adds
   (allocated and reserved).
4. Host µs per step (call to return, the queue drained before each step)
   and the step on the card's clock (CUDA events, the queue empty at its
   start), eager (the key's graphs dropped before each step, so each is a
   first sight) against graphed; the kernels' busy ms per forward in 2.
5. For each UNet, its keys captured one after another into its one pool,
   nothing dropped between them: each loop's replay against its own eager
   ε, then two loops of its first key replayed from two threads at once,
   each against its ε replayed alone; the bytes of the private pools
   (`torch.cuda.memory_snapshot`) and the reserved bytes they add, and the
   pools' bytes left after `unet_graph.release` (0 once the cache is
   emptied).

The last line of output is the JSON summary; --out also writes it.
Exit status 1 if a check fails.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS = 10  # timed steps per mode
LATENT = 128  # 1024² images
TEXT_TOKENS, IP_TOKENS = 77, 4


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def kernels(prof, torch):
    """Kernel names (a Counter), the input copies and fills, and the busy ms
    of the device ops in a profile."""
    names, n_io, busy_us = collections.Counter(), 0, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += e.time_range.elapsed_us()
        if e.name.lower().startswith(("memcpy", "memset")):
            n_io += 1
        else:
            names[e.name] += 1
    return names, n_io, busy_us / 1e3


def build(torch, unet_lib, cfg):
    with torch.device("cuda"):
        net = unet_lib.UNet(cfg)
    return net.to(torch.bfloat16).requires_grad_(False).eval()


def make_loop(torch, sampler, net, cfg, rows, guidance, ip, g):
    """The eps_fn of one loop at `rows` latent rows and its input."""
    dt, dev = torch.bfloat16, "cuda"

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale

    ctx = r(rows, TEXT_TOKENS, cfg.cross_attention_dim).to(dt)
    pooled = r(rows, cfg.pooled_dim).to(dt)
    tid = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024][:cfg.num_time_ids]],
                       device=dev).repeat(rows, 1)
    kw = {}
    if guidance > 1.0:
        kw.update(ctx_uncond=r(rows, TEXT_TOKENS, cfg.cross_attention_dim).to(dt),
                  pooled_uncond=r(rows, cfg.pooled_dim).to(dt))
    else:
        kw.update(ctx_uncond=None, pooled_uncond=None)
    if ip:
        kw.update(ip_tokens=r(rows, IP_TOKENS, cfg.cross_attention_dim).to(dt), ip_scale=1.0,
                  ip_step_window=(0, 25))
    fn = sampler.make_cfg_eps_fn(net, cfg, ctx, kw.pop("ctx_uncond"), pooled,
                                 kw.pop("pooled_uncond"), tid, guidance, **kw)
    lat = r(rows, LATENT, LATENT, 4)
    return fn, lat


def check_key(torch, fa, sampler, unet_graph, net, cfg, name, rows, guidance, ip, failures):
    g = torch.Generator(device="cuda").manual_seed(rows * 7919 + len(name))
    runner = unet_graph.graphs_of(net)
    runner.clear()
    fn, lat = make_loop(torch, sampler, net, cfg, rows, guidance, ip, g)
    out = {"key": name, "latent_rows": rows, "unet_rows": rows * (2 if guidance > 1 else 1)}

    def call(t, i):
        n0 = fa.flash_fwd_cuda.launches
        with torch.inference_mode():
            eps = fn(lat, t, i).clone()
        torch.cuda.synchronize()
        return eps, fa.flash_fwd_cuda.launches - n0

    counts0 = (runner.eager, runner.captures, runner.replays)
    eps_e, k1_e = call(500, 0)
    torch.cuda.synchronize()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eps_c, k1_c = call(500, 1)
    out["capture_s"] = time.perf_counter() - t0
    out["capture_added_allocated_bytes"] = torch.cuda.memory_allocated() - alloc0
    out["capture_added_reserved_bytes"] = torch.cuda.memory_reserved() - res0
    eps_r, k1_r = call(500, 2)
    counts = [b - a for a, b in zip(counts0, (runner.eager, runner.captures, runner.replays))]
    out["segments"] = runner.segments
    out["counts"] = dict(zip(("eager", "captures", "replays"), counts))
    out["max_abs_diff_capture"] = float((eps_c.float() - eps_e.float()).abs().max())
    out["max_abs_diff_replay"] = float((eps_r.float() - eps_e.float()).abs().max())
    out["bit_identical"] = bool(torch.equal(eps_r, eps_e) and torch.equal(eps_c, eps_e))
    out["finite"] = bool(torch.isfinite(eps_e.float()).all())
    out["k1_per_forward"] = {"eager": k1_e, "capture": k1_c, "replay": k1_r}
    if not k1_e == k1_c == k1_r > 0:
        failures.append(f"{name}: K1 launches {k1_e}/{k1_c}/{k1_r}")
    if counts != [1, 1, 1]:
        failures.append(f"{name}: counts {out['counts']}")
    if not out["finite"]:
        failures.append(f"{name}: eager ε not finite")
    if not out["bit_identical"]:
        failures.append(f"{name}: captured or replayed ε differs from eager by up to "
                        f"{max(out['max_abs_diff_capture'], out['max_abs_diff_replay'])}")

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    found = {}
    with torch.inference_mode():
        for mode in ("eager", "graphed"):
            if mode == "eager":
                runner.clear()  # a first sight: the eager forward
            else:
                fn(lat, 500, 3)  # the second sight: captured
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                fn(lat, 500, 3)  # t and the scale as last time: the graphs' inputs need no fill
                torch.cuda.synchronize()
            found[mode] = kernels(prof, torch)
    (ne, io_e, busy_e), (ng, io_g, busy_g) = found["eager"], found["graphed"]
    out["profile"] = {
        "eager": {"kernels": sum(ne.values()), "input_copies": io_e, "busy_ms": busy_e},
        "graphed": {"kernels": sum(ng.values()), "input_copies": io_g, "busy_ms": busy_g},
        "kernels_only_eager": dict((ne - ng).most_common(8)),
        "kernels_only_graphed": dict((ng - ne).most_common(8)),
    }
    # the eager forward copies its timestep in, a replay its latent in and ε out:
    # each a memcpy or a copy kernel; every other device op is the same in both
    total_e, total_g = sum(ne.values()) + io_e, sum(ng.values()) + io_g
    if total_e + 1 != total_g:
        failures.append(f"{name}: device ops per forward {total_e} eager, {total_g} graphed")

    timing = {}
    with torch.inference_mode():
        for mode in ("eager", "graphed"):
            host, dev = [], []
            runner.clear()
            if mode == "graphed":
                fn(lat, 900, 4)
                fn(lat, 900, 4)  # captured
            for i in range(STEPS + 1):
                if mode == "eager":
                    runner.clear()  # every step a first sight
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                fn(lat, 900 - 37 * i, 4 + i)
                b.record()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                if i:  # the first step of each mode is a warm-up
                    host.append((t1 - t0) * 1e6)
                    dev.append(a.elapsed_time(b))
            timing[mode] = {"host_us_per_step": sum(host) / len(host),
                            "step_ms_on_card_clock": sum(dev) / len(dev)}
    out["timing"] = timing
    return out


def pool_bytes(torch) -> int:
    """Bytes of the segments that private pools (CUDA graphs') hold."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id") or (0, 0)) != (0, 0))


def check_shared_pool(torch, sampler, unet_graph, net, cfg, keys, failures):
    """Every key of one UNet captured into its pool, none dropped, each
    loop's replay against its own eager ε; two loops of the first key on two
    threads; the pool's bytes, and what `release` leaves of them."""
    import gc
    import threading

    runner = unet_graph.graphs_of(net)
    runner.clear()
    gc.collect()
    torch.cuda.empty_cache()
    res0, pool0 = torch.cuda.memory_reserved(), pool_bytes(torch)
    loops, out = [], {"unet": list(cfg.block_out_channels), "keys": []}
    with torch.inference_mode():
        for name, rows, guidance, ip in keys:
            g = torch.Generator(device="cuda").manual_seed(rows * 104729 + len(name))
            fn, lat = make_loop(torch, sampler, net, cfg, rows, guidance, ip, g)
            eager = fn(lat, 500, 0).clone()  # a first sight
            fn(lat, 500, 1)  # captured
            loops.append((f"{name}@{rows}", fn, lat, eager))
        for key, fn, lat, eager in loops:
            same = torch.equal(fn(lat, 500, 2), eager)
            out["keys"].append({"key": key, "bit_identical": bool(same)})
            if not same:
                failures.append(f"shared pool, {key}: replay differs from eager")
        name, rows, guidance, ip = keys[0]
        g = torch.Generator(device="cuda").manual_seed(rows * 15485863 + len(name))
        fn_b, lat_b = make_loop(torch, sampler, net, cfg, rows, guidance, ip, g)
        alone = {"a": (loops[0][1], loops[0][2], loops[0][3]),
                 "b": (fn_b, lat_b, fn_b(lat_b, 500, 3).clone())}
    torch.cuda.synchronize()
    counts0 = runner.replays
    bad, errors = [], []

    def worker(who):
        fn, lat, want = alone[who]
        try:
            with torch.inference_mode():
                for i in range(8):
                    if not torch.equal(fn(lat, 500, 4 + i), want):
                        bad.append((who, i))
        except BaseException as e:  # noqa: BLE001  (reported as a failure)
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(w,)) for w in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out["two_threads"] = {"key": f"{name}@{rows}", "forwards": runner.replays - counts0,
                          "differing": bad, "errors": errors}
    if bad or errors or runner.replays - counts0 != 16:
        failures.append(f"two threads at {name}@{rows}: {out['two_threads']}")
    torch.cuda.synchronize()
    out["pool_bytes"] = pool_bytes(torch) - pool0
    out["reserved_added_bytes"] = torch.cuda.memory_reserved() - res0
    out["segments"] = runner.segments
    del loops, alone, fn, fn_b, lat, lat_b, eager
    unet_graph.release(net)
    gc.collect()
    torch.cuda.empty_cache()
    out["pool_bytes_after_release"] = pool_bytes(torch) - pool0
    if out["pool_bytes_after_release"] > 0:
        failures.append(f"shared pool of {out['unet']}: {out['pool_bytes_after_release']} bytes "
                        "left after release")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the summary to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("unet_graph_check: no CUDA device", file=sys.stderr)
        return 2
    from instructany2pix_tpu_torch.diffusion import sampler, unet_graph
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa

    failures: list = []
    result = {"card": card_line(), "torch": torch.__version__, "keys": [], "shared_pool": []}
    plans = [
        ("base", unet_lib.UNetConfig.sdxl_base(with_ip=True),
         [("inversion", 1, 1.0, False), ("inversion", 4, 1.0, False),
          ("ip_denoise", 1, 10.0, True), ("ip_denoise", 4, 10.0, True)]),
        ("refiner", unet_lib.UNetConfig.sdxl_refiner(),
         [("refiner", 1, 10.0, False), ("refiner", 4, 10.0, False)]),
    ]
    for _, cfg, keys in plans:
        net = build(torch, unet_lib, cfg)
        for name, rows, guidance, ip in keys:
            row = check_key(torch, fa, sampler, unet_graph, net, cfg, name, rows, guidance, ip,
                            failures)
            result["keys"].append(row)
            print(json.dumps(row), flush=True)
        row = check_shared_pool(torch, sampler, unet_graph, net, cfg, keys, failures)
        result["shared_pool"].append(row)
        print(json.dumps(row), flush=True)
        unet_graph.graphs_of(net).clear()
        del net
        torch.cuda.empty_cache()
    result["failures"] = failures
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print(text)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
