"""One rank of a tensor-parallel run of the port on the CPU (gloo), for
tests/test_torch_sharding.py.  Not a test file: each rank runs in a process
of its own,

    python tests/torch_tp_worker.py JOB RANK WORLD INIT_METHOD OUT_DIR ARGS_JSON

and writes what it computed to ``OUT_DIR/JOB.rank<RANK>.pt``.  Imports the
port only (no JAX), so that a rank starts in about a second.

Jobs:

* ``generate`` — ``Dia.shard`` on a (data, model) mesh of ``ARGS["mesh"]``,
  then greedy codes of the float, int8 (int8 KV caches) and int4 (group 16,
  halfsplit) routes, each packed shard unpacked, a few float shards, the loss
  forward under the mesh and its gradients (``loss_grads``); with
  ``ARGS["mesh_checks"]`` (4 ranks) the mesh shapes and errors, with
  ``ARGS["route_checks"]`` every route that must raise under a mesh.
* ``cbatch`` — a two-rank ``ContinuousBatcher(mesh=)``: rank 0 submits a
  greedy, a seeded and a streamed request while rank 1 follows; then a
  second batcher whose follower fails at its first admission.
* ``train`` — ``Trainer(mesh=)`` on each case of ``ARGS["cases"]``
  (``TRAIN_CASES``: a mesh, a layout, a mode and its steps) from the fp32
  weights ``ARGS["weights"]`` and the global batches ``ARGS["batches"]``:
  the reduced gradients before the first step, every step's metrics, the
  whole trained tree or adapter after them, the moments' shapes; a case
  with ``save`` writes a checkpoint after its first step, one with
  ``resume`` starts from a checkpoint.
"""

from __future__ import annotations

import datetime
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dia_tts_prune_tpu_torch import Dia  # noqa: E402
from dia_tts_prune_tpu_torch.config import (  # noqa: E402
    DataConfig,
    DecoderConfig,
    DiaConfig,
    EncoderConfig,
    ModelConfig,
)
from dia_tts_prune_tpu_torch.parallel import sharding  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)  # a dead rank fails its peers' collectives
TEXT = "[S1] sharded gen"
TOKENS = 40
PACKED = (("self_attention", "q_proj"), ("self_attention", "o_proj"), ("mlp", "wi_fused"),
          ("mlp", "wo"), ("cross_attention", "o_proj"))


def tp_config() -> DiaConfig:
    """tests/test_sharding.py's ``_tp_config``: 8 query heads over 4 KV heads."""
    return DiaConfig(
        model=ModelConfig(
            encoder=EncoderConfig(n_layer=2, n_embd=64, n_hidden=256, n_head=8, head_dim=16),
            decoder=DecoderConfig(n_layer=2, n_embd=64, n_hidden=256, gqa_query_heads=8,
                                  kv_heads=4, gqa_head_dim=16, cross_query_heads=8,
                                  cross_head_dim=16),
            src_vocab_size=256, tgt_vocab_size=1028),
        data=DataConfig(text_length=128, audio_length=128))


def model(weights: str) -> Dia:
    return Dia(tp_config(), torch.load(weights), device="cpu")


def unpacked(qk) -> dict:
    """A packed kernel's int values as rows [L, K, N], its scales, its format."""
    from dia_tts_prune_tpu_torch.ops.quant import Quantized4Kernel, unpack_nibble_rows

    values = qk.values
    if isinstance(qk, Quantized4Kernel):
        values = unpack_nibble_rows(values, qk.halfsplit) if qk.nibble else values
        fmt = (qk.group, qk.nibble, qk.halfsplit)
    else:
        fmt = ("int8",)
    return {"rows": values.clone(), "scale": qk.scale.clone(), "format": fmt}


def raises(fn) -> str:
    """The type and message of what ``fn()`` raises ('' if nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — recorded for the test to check
        return f"{type(e).__name__}: {e}"
    return ""


def mesh_checks() -> dict:
    """make_mesh / make_hybrid_mesh shapes and errors on 4 ranks."""
    out = {
        "2x2": sharding.make_mesh(data=2, model=2, device="cpu").shape,
        "default": sharding.make_mesh(device="cpu").shape,
        "model_only": sharding.make_mesh(model=2, device="cpu").shape,
        "3x4": raises(lambda: sharding.make_mesh(data=3, model=4, device="cpu")),
    }
    hybrid = sharding.make_hybrid_mesh(replica=2, data=2, model=1, device="cpu")
    out["hybrid"] = (hybrid.shape, hybrid.mesh_dim_names)
    out["hybrid_via_make_mesh"] = sharding.make_mesh(data=2, model=1, replica=2,
                                                     device="cpu").shape
    out["hybrid_3x2x2"] = raises(lambda: sharding.make_hybrid_mesh(replica=3, data=2, model=2))
    out["batch_spec_hybrid"] = tuple(sharding.batch_spec(3, hybrid))
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    out["batch_rows_hybrid"] = sharding.shard_batch({"x": x}, hybrid)["x"]
    return out


def loss_batch(cfg):
    from dia_tts_prune_tpu_torch.train import build_train_batch

    rng = np.random.default_rng(0)
    text = rng.integers(1, 200, (2, cfg.data.text_length)).astype(np.int32)
    text[:, 40:] = 0
    codes = [rng.integers(0, 1024, (60, 9)).astype(np.int32) for _ in range(2)]
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            build_train_batch(cfg, text, codes).items()}


GRAD_LEAVES = (("decoder", "layers", "mlp", "wo", "kernel"),
               ("decoder", "layers", "pre_sa_norm", "scale"),
               ("encoder", "embedding", "embedding"))


def loss_grads(params, cfg, batch, group=None) -> dict:
    """The gradients of the loss (the whole batch) with respect to
    ``GRAD_LEAVES``: a row-parallel kernel (a rank's rows under a mesh) and
    two replicated leaves upstream of every model-axis sum."""
    from dia_tts_prune_tpu_torch.train import compute_loss

    def swap(tree, path, leaf):  # a copy of the tree with the leaf at path replaced
        if len(path) == 1:
            return {**tree, path[0]: leaf}
        return {**tree, path[0]: swap(tree[path[0]], path[1:], leaf)}

    leaves = []
    for path in GRAD_LEAVES:
        node = params
        for k in path:
            node = node[k]
        leaves.append(node.detach().requires_grad_(True))
        params = swap(params, path, leaves[-1])
    grads = torch.autograd.grad(compute_loss(params, cfg, batch, group=group), leaves)
    return {".".join(p): g for p, g in zip(GRAD_LEAVES, grads)}


def job_generate(rank: int, args: dict) -> dict:
    from dia_tts_prune_tpu_torch.train import compute_loss

    mesh = sharding.make_mesh(*args["mesh"], device="cpu")
    out = {"shape": mesh.shape, "coord": mesh.get_coordinate()}
    if args.get("mesh_checks"):
        out["mesh"] = mesh_checks()
    for route in ("float", "int8", "int4"):
        dia = model(args["weights"])
        dia.shard(mesh)
        if route == "float":
            layers = dia.params["decoder"]["layers"]
            out["float_shards"] = {f"{a}.{k}": layers[a][k]["kernel"].clone() for a, k in PACKED}
            group = sharding.model_group(mesh)
            batch = loss_batch(dia.config)
            with torch.no_grad():
                out["loss"] = float(compute_loss(dia.params, dia.config, batch, group=group))
            out["grads"] = loss_grads(dia.params, dia.config, batch, group)
        elif route == "int8":
            dia.quantize_int8()
        else:
            dia.quantize_int4(group=16, halfsplit=True)
        if route != "float":
            layers = dia.params["decoder"]["layers"]
            out[f"packed_{route}"] = {f"{a}.{k}": unpacked(layers[a][k]["kernel"])
                                      for a, k in PACKED}
        out[f"codes_{route}"] = dia.generate_codes(TEXT, max_tokens=TOKENS, temperature=0.0)
    if args.get("route_checks"):
        out["raises"] = route_raises(args["weights"], mesh)
    return out


def route_raises(weights: str, mesh) -> dict:
    """Every route without a tensor-parallel form, under the mesh, and the
    sharding errors."""
    from dia_tts_prune_tpu_torch.serving import DynamicBatcher

    dia = model(weights)
    dia.shard(mesh)
    gen = dia.generator
    out = {
        "fused": raises(lambda: dia.quantize_int8(fused=True)),
        "speculative": raises(lambda: dia.generate_codes(TEXT, max_tokens=8, speculative=4)),
        "dynamic_batcher": raises(lambda: DynamicBatcher(dia)),
        "gloo_capturable": sharding.capturable(gen.group),
        "indivisible": raises(lambda: sharding.local_shard(
            torch.zeros(2, 3, 4), sharding.P(None, sharding.AXIS_MODEL, None), mesh, "x")),
    }
    real = gen.device
    gen.device = torch.device("cuda")  # the rule alone: the loops a gloo mesh on CUDA takes
    try:
        out["graph_loop_gloo"] = raises(lambda: gen._loop(None))
        out["eager_loop_gloo"] = raises(lambda: gen._loop("eager"))
    finally:
        gen.device = real
    packed = model(weights)
    packed.quantize_int8()
    out["shard_packed"] = raises(lambda: sharding.shard_params(packed.params, mesh,
                                                              config=packed.config))
    sparse = model(weights)
    sparse.sparsify_block((16, 16))
    out["shard_block_sparse"] = raises(lambda: sharding.shard_params(sparse.params, mesh,
                                                                    config=sparse.config))
    sparse.mesh = mesh  # a model under the mesh whose kernels are block-sparse
    out["block_sparse"] = raises(lambda: sparse._set_params(sparse.params))
    return out


def job_cbatch(rank: int, args: dict) -> dict:
    from dia_tts_prune_tpu_torch import cbatch

    mesh = sharding.make_mesh(data=1, model=2, device="cpu")
    dia = model(args["weights"])
    dia.shard(mesh)
    out = {}
    cb = cbatch.ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=args["max_tokens"],
                                  text_window=128, mesh=mesh)
    if cb.leader:
        try:
            reqs = args["requests"]
            futs = []
            for i, (text, temperature, seed) in enumerate(reqs[:2]):
                futs.append(cb.submit(text, temperature=temperature, seed=seed))
                if i == 0:
                    time.sleep(0.05)
            text, temperature, seed = reqs[2]
            out["stream"] = np.concatenate(list(cb.submit_stream(text, temperature=temperature,
                                                                 seed=seed)))
            out["lanes"] = [f.result(300) for f in futs]
            out["stats"] = dict(cb.stats)
        finally:
            cb.shutdown()
    else:
        cb.follow()

    # a follower that fails: every waiting request gets an error, and the follower ends
    if rank == 1:
        def boom(*a, **k):
            raise RuntimeError("rank 1 lost its lane")

        cbatch.swap_in = boom
    cb2 = cbatch.ContinuousBatcher(dia, n_slots=2, segment_steps=8,
                                   max_tokens=args["max_tokens"], text_window=128, mesh=mesh)
    if cb2.leader:
        fut = cb2.submit(args["requests"][0][0], temperature=0.0, seed=1)
        out["failed_request"] = raises(lambda: fut.result(120))
        out["after_failure"] = raises(lambda: cb2.submit("[S1] more"))
        cb2.shutdown()
    else:
        out["follower"] = raises(cb2.follow)
    return out


# name: (mesh (data, model) or (replica, data, model), fsdp, TrainConfig fields, steps)
TRAIN_CASES = {
    "full_12": ((1, 2), False, {}, 1),
    "full_21": ((2, 1), False, {}, 1),
    "full_22": ((2, 2), False, {}, 1),
    "fsdp_21": ((2, 1), True, {}, 2),
    "fsdp_22": ((2, 2), True, {}, 1),
    "hybrid_212": ((2, 1, 2), False, {}, 1),
    "lora_12": ((1, 2), False, {"adapter_mode": "lora"}, 2),
    "lora_22": ((2, 2), False, {"adapter_mode": "lora"}, 2),
    "qat_12": ((1, 2), False, {"qat_mode": "int8"}, 1),
    "accum_21": ((2, 1), False, {"gradient_accumulation_steps": 2}, 2),
    "resume_12": ((1, 2), False, {}, 1),
    "remat_12": ((1, 2), False, {"remat": True}, 1),
    "one_11": ((1, 1), False, {"adapter_mode": "lora"}, 1),
}
LORA_TARGETS = ("q_proj", "v_proj", "o_proj", "wi_fused", "wo")


def train_config(fields: dict):
    """JAX's test_sharding TrainConfig (lr 3e-3, no remat, clip 1.0) with
    ``fields``; LoRA on column and row-parallel targets."""
    from dia_tts_prune_tpu_torch.lora import LoraConfig
    from dia_tts_prune_tpu_torch.train import TrainConfig

    kw = {"learning_rate": 3e-3, "remat": False, "max_grad_norm": 1.0,
          "lora": LoraConfig(r=4, alpha=8.0, target_modules=LORA_TARGETS)}
    return TrainConfig(**{**kw, **fields})


def column_max_differs(params, mesh) -> bool:
    """Whether some column of a row-parallel decoder kernel has its largest
    |w| outside this rank's slice of K (so QAT needs the mesh-wide max)."""
    import torch.distributed as dist

    layers = params["decoder"]["layers"]
    for kernel in (layers["mlp"]["wo"]["kernel"], layers["self_attention"]["o_proj"]["kernel"]):
        local = kernel.abs().flatten(1, -2).amax(dim=1)  # [L, N]: o_proj [L, N, H, D] -> K = N*H
        whole = local.clone()
        dist.all_reduce(whole, op=dist.ReduceOp.MAX, group=sharding.model_group(mesh))
        if bool((local != whole).any()):
            return True
    return False


def job_train(rank: int, args: dict) -> dict:
    from dia_tts_prune_tpu_torch.train import Trainer

    weights = torch.load(args["weights"])
    batches = [dict(np.load(b)) for b in args["batches"]]
    out = {}
    for name in args["cases"]:
        shape, fsdp, fields, steps = TRAIN_CASES[name]
        mesh = (sharding.make_mesh(replica=shape[0], data=shape[1], model=shape[2], device="cpu")
                if len(shape) == 3 else sharding.make_mesh(*shape, device="cpu"))
        cfg = tp_config()
        local = sharding.shard_params(weights, mesh, config=cfg, fsdp=fsdp)
        tr = Trainer(local, cfg, train_config(fields), 10, mesh=mesh)
        rec = {"coord": mesh.get_coordinate()}
        if name == "resume_12":
            tr.restore(args["resume_from"])
        loss, grads = tr.gradients(batches[0])
        rec["grad_loss"] = loss
        rec["replicated_grads"] = {n: g.clone() for n, g in grads.items()
                                   if not tr.plan.leaves[n].axes}
        rec["moment_shapes"] = {n: tuple(m.shape) for n, m in tr.optimizer.mu.items()}
        rec["leaf_shapes"] = {n: tuple(p.shape) for n, p in tr.optimizer.leaves.items()}
        if fields.get("qat_mode"):
            rec["column_max_differs"] = column_max_differs(local, mesh)
        lora = fields.get("adapter_mode") == "lora"
        rec["metrics"] = []
        for i in range(steps):
            rec["metrics"].append(tr.step(batches[i % len(batches)]))
            if i == 0 and args.get("save") == name:
                tr.save(args["save_to"], step=1)
            if i == 0 and not lora:
                rec["first_step"] = tr.trained_params()
        rec["adapter"] = tr.adapter()
        rec["trained"] = None if lora else tr.trained_params()
        out[name] = rec
    return out


def main() -> int:
    job, rank, world, init, out_dir, args = sys.argv[1:7]
    rank, world, args = int(rank), int(world), json.loads(args)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        result = {"job_generate": job_generate, "job_cbatch": job_cbatch,
                  "job_train": job_train}["job_" + job](rank, args)
        torch.save(result, Path(out_dir) / f"{job}.rank{rank}.pt")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
