"""The rank side of the port's mesh tests: `python torch_port_ranks.py
<target> <rank> <world> <run dir>` joins a gloo process group through
`file://<run dir>/rdv`, builds the (n_data, n_model) mesh the payload names
on the CPU, runs `<target>(payload, mesh)` and pickles what it returns to
`<run dir>/rank<r>.out.pkl`. `torch_port_helpers.spawn_ranks` starts one
process per rank and reads the results. Imports neither JAX nor the JAX
package: the test that spawns the ranks computes the JAX side itself and
hands the ranks numpy inputs and weights.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from instructany2pix_tpu_torch.core import mesh as M  # noqa: E402
from instructany2pix_tpu_torch.parallel import collectives as C  # noqa: E402
from instructany2pix_tpu_torch.parallel import sharding as sh  # noqa: E402


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------- mesh basics


def mesh_basics(payload, mesh):
    """Coordinates, shard_batch, each collective wrapper with its counts,
    the TP context's refusal, and a worker thread's own mesh."""
    out = {"coords": mesh.coords(), "shape": dict(mesh.shape)}
    batch = {"x": torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2), "y": [torch.arange(5)]}
    local = M.shard_batch(batch, mesh)
    out["x_rows"], out["y_rows"] = local["x"].tolist(), local["y"][0].tolist()
    C.reset_counts()
    r = torch.tensor([float(mesh.rank + 1)] * 3)
    out["reduce_model"] = C.all_reduce(r, mesh.group(M.MODEL_AXIS)).tolist()
    out["reduce_data"] = C.all_reduce(r, mesh.group(M.DATA_AXIS)).tolist()
    out["gather_model"] = C.all_gather(torch.tensor([mesh.rank]), 0, mesh.group(M.MODEL_AXIS)).tolist()
    out["bcast_data"] = C.broadcast(torch.tensor([mesh.rank]), 0, mesh.group(M.DATA_AXIS)).tolist()
    out["ring_model"] = C.ring_shift([torch.tensor([mesh.rank])], mesh.group(M.MODEL_AXIS))[0].tolist()
    out["counts"] = C.counts()
    try:
        sh.model_all_reduce(r)
        out["outside_tp"] = "no error"
    except RuntimeError as e:
        out["outside_tp"] = str(e)
    seen = {}

    def worker():
        seen["before"] = M.current_mesh()
        with M.use_mesh(mesh), sh.tp_activation_constraints(mesh):
            seen["inside"] = M.current_mesh() is mesh and sh.tp_mesh() is mesh

    with M.use_mesh(M.abstract_mesh(9, 9)):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        out["main_mesh_kept"] = M.current_mesh().n_data == 9
    out["thread_before"] = seen["before"]
    out["thread_inside"] = seen["inside"]
    return out


# ------------------------------------------------------------ ring attention


def ring(payload, mesh):
    from instructany2pix_tpu_torch.parallel.ring_attention import ring_attention

    outs = []
    C.reset_counts()
    for case in payload["cases"]:
        axis = case["axis"]
        n, idx = mesh.shape[axis], mesh.axis_index(axis)
        q, k, v = (torch.from_numpy(case[x]) for x in "qkv")
        s_loc = q.shape[1] // n
        sl = slice(idx * s_loc, (idx + 1) * s_loc)
        o = ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh, axis=axis, causal=case["causal"])
        outs.append(_np(o))
    return {"outs": outs, "counts": C.counts()}


# -------------------------------------------------------- tensor parallelism


def tp_denoise(payload, mesh):
    """The BatchedDenoiser on the mesh, and TP decodes of a quantized LLaMA."""
    from instructany2pix_tpu_torch import convert, serving
    from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
    from instructany2pix_tpu_torch.llm import generate as gen_lib
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib

    out = {}
    ucfg = unet_lib.UNetConfig(**payload["unet_cfg"])
    unet = convert.unet(payload["unet"], ucfg)
    den = serving.BatchedDenoiser(lambda: unet, ucfg, schedule=Schedule.create(), mesh=mesh)
    C.reset_counts()
    reqs = [serving.EditRequest(**r) for r in payload["reqs"]]
    out["denoise"] = np.stack(den.run_batch(reqs))
    out["denoise_counts"] = C.counts()
    out["sharded"] = sorted(n for n, m in unet.named_modules() if getattr(m, "tp", None))

    lcfg = llama_lib.LlamaConfig(**payload["llama_cfg"])
    g = payload["gen"]
    for key in ("llama", "llama_int4"):  # o and down at int8 (row-split), and int4 (gathered)
        lm = convert.llama(payload[key], lcfg)
        llama_lib.shard_tp(lm, lcfg, mesh)
        kinds = {n: m.tp for n, m in lm.named_modules() if getattr(m, "tp", None)}
        with sh.tp_activation_constraints(mesh):
            C.reset_counts()
            res = gen_lib.generate(lm, lcfg, torch.from_numpy(g["emb"]), None,
                                   gumbel=torch.from_numpy(g["gumbel"]),
                                   prefix_pads=torch.from_numpy(g["pads"]), **g["kw"])
        out[key] = {"kinds": kinds, "tokens": res.tokens.numpy(), "hiddens": _np(res.hiddens),
                    "done_at": res.done_at.numpy(), "counts": C.counts()}
    return out


def _stub_outcome(r, emb_dim):
    """The fixed LLM outcome of a stub request: an image edit seeded from its
    seed (tests/test_torch_serving.py `_stub`)."""
    if not r.mm_data:
        return (None, None, "caption only", None, None)
    rk = np.random.RandomState(r.seed)
    return (rk.randn(1, emb_dim).astype(np.float32), rk.randn(emb_dim).astype(np.float32),
            f" a scene {r.seed}", r.mm_data[0]["fname"],
            dict(all_objs=[], extra_embeds=[], extra_idx=[]))


def pipeline_server(payload, mesh):
    """The PipelineServer over the mesh: rank 0 submits the batches; every
    other rank follows. Requests whose instruction starts with "stub:" take
    a fixed LLM outcome (so the diffusion stages always run); the others
    the real batched decode with injected draws."""
    from instructany2pix_tpu_torch import pipeline as tpl
    from instructany2pix_tpu_torch import serving
    from instructany2pix_tpu_torch.core.dtypes import FP32

    pipe = tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), params=payload["params"],
                                       device="cpu", policy=FP32, mesh=mesh)
    emb_dim = pipe.cfg.llm.image_codec_dim

    class Server(serving.PipelineServer):
        def _llm_stage(self, reqs):
            if reqs[0].inst.startswith("stub:"):
                return [_stub_outcome(r, emb_dim) for r in reqs]
            return super()._llm_stage(reqs)

    server = Server(pipe, mesh=mesh, max_batch=4, max_wait_s=1.0,
                    max_new_tokens=payload.get("max_new_tokens", 100))
    out = {"rank": mesh.rank}
    if mesh.rank != 0:
        out["released"] = server.wait(timeout=100)
        out["counts"] = C.counts()
        return out
    C.reset_counts()
    try:
        for name, batch in payload["batches"]:
            futs = [server.submit(serving.PipelineRequest(**r)) for r in batch]
            res = [f.result(timeout=100) for f in futs]
            out[name] = [(r.caption, r.image) for r in res]
            out[name + "_tokens"] = (None if server.last_generate is None
                                     else server.last_generate.tokens.numpy())
    finally:
        server.stop()
    out["counts"] = C.counts()
    return out


# ----------------------------------------------------------------- training


def fsdp_train(payload, mesh):
    """FSDP training steps on the mesh from converted JAX weights, the
    gathered checkpoint, a restore of the one-process file, and the
    launcher's --n-model run."""
    from instructany2pix_tpu_torch import convert
    from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.train import launch
    from instructany2pix_tpu_torch.train import train_step as ts

    torch.set_grad_enabled(True)
    pcfg = mm.Any2PixLMConfig.tiny(payload["token_ids"])
    tcfg = ts.TrainConfig(**payload["tcfg"])
    module = convert.llm(payload["params"], pcfg, trainable=True)
    init_state, step = ts.make_train_step(pcfg, tcfg, mesh=mesh)
    state = init_state(module)
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    metrics = []
    for _ in range(payload["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = ts.full_state(state)
    out = {"metrics": metrics, "rank": mesh.rank,
           "n_sharded": sum(1 for p in module.parameters() if hasattr(p, "placements")),
           "n_replicated": len(module.fsdp_replicated)}
    if mesh.rank == 0:
        path = os.path.join(payload["run"], "fsdp.pt")
        ckpt_lib.save(path, whole)
        out["ckpt"] = path
    # the one-process file, restored at this mesh and gathered back
    if payload.get("restore"):
        other = init_state(convert.llm(payload["params"], pcfg, trainable=True))
        ts.restore_state(payload["restore"], other)
        back = ts.full_state(other)
        out["restored"] = {"params": {k: v.numpy() for k, v in back["params"].items()},
                           "mu": [m.numpy() for m in back["opt_state"]["mu"]],
                           "step": back["step"], "count": back["opt_state"]["count"]}
    if payload.get("launch"):
        args = payload["launch"] + ["--n-model", str(mesh.n_model),
                                    "--ckpt-dir", os.path.join(payload["run"], "launch_ck")]
        res = launch.main(args, device="cpu")
        out["launch"] = {"history": res["history"], "saves": res["saves"]}
    return out


# --------------------------------------------------------------------- main


def main(argv):
    target, rank, world, run = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(run, "payload.pkl"), "rb") as f:
        payload = pickle.load(f) or {}
    payload.setdefault("run", run)
    M.init_distributed("gloo", f"file://{os.path.join(run, 'rdv')}", rank, world, timeout_s=100)
    n_data, n_model = payload.get("mesh", (world, 1))
    mesh = M.make_mesh(n_data, n_model, device="cpu")
    out = globals()[target](payload, mesh)
    with open(os.path.join(run, f"rank{rank}.out.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
