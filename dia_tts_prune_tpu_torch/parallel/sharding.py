"""Mesh construction and sharding rules over ``torch.distributed`` (counterpart
of ``dia_tts_prune_tpu/parallel/sharding.py``).

The plan is the JAX package's: a mesh with axes ``("data", "model")``
(``("replica", "data", "model")`` for the hybrid layout); the model axis
shards attention heads and the FFN hidden dimension, the data axis the
batch; embeddings, norms and the logits head are replicated.  What differs
is who does the work:

* JAX drives every chip from one process and XLA's partitioner lays out the
  arrays and emits the collectives.  Here each process runs one rank, and
  each rank holds the *local shard* of every sharded leaf as a plain tensor
  on its device (``shard_params``): the port's kernels take raw pointers
  and contiguous tensors, so there is no ``DTensor`` in between.
* The collectives are written out: ``o_proj`` and ``wo`` leave a partial sum
  over D on every rank, and ``ops/modules.py`` all-reduces it over the
  mesh's model group (``model_psum`` in ``attention_out`` and
  ``mlp_block``).  Those two points are the only places where the ranks of
  a model group meet in a forward pass.  Training adds their partners
  (``model_copy``: the gradient of a replicated activation that enters a
  column-parallel product, summed over the model group), the FSDP pair
  (``data_gather``: a leaf's data shard all-gathered before use, its
  gradient reduce-scattered) and the gradient sums over the batch axes
  (``train.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over a process
group that the caller has initialized, and so whose backend the caller
chose: NCCL with one card a rank, or gloo (CPU tensors, or CUDA tensors
staged through the host).  Nothing here swaps one for the other.  Every
subgroup of the mesh gets ``TIMEOUT``, so that a dead rank ends a
collective with an error rather than a hang.

Not ported: ``active_mesh`` and ``constrain``.  They exist because XLA lays
out traced arrays, and a constraint tells it which layout to keep.  With
local shards the layout is the tensor that a rank holds, so there is nothing
to constrain.  For the same reason a dimension that does not divide over its
mesh axis raises in ``shard_params``, where the JAX ``constrain`` would drop
the axis and replicate.
"""

from __future__ import annotations

import datetime
import math
import zlib
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config import DiaConfig

Params = dict[str, Any]

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_REPLICA = "replica"  # pure data parallelism across hosts

# every subgroup's collective timeout: a rank that died ends its peers' waits
TIMEOUT = datetime.timedelta(seconds=300)


class P(tuple):
    """A ``PartitionSpec``-like spec: one mesh axis name (or a tuple of
    them, or None) per dimension of a leaf.  A tuple, so that it compares
    with the JAX package's specs leaf by leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def make_mesh(data: int | None = None, model: int | None = None, device: str = "cuda",
              replica: int | None = None):
    """A (data, model) mesh over the ranks of the initialized default group.

    Defaults: every rank on the model axis (tensor parallelism first, as in
    the JAX package: single-stream generation is bound by weight reads, which
    tensor parallelism divides).  ``replica`` adds a leading axis
    (``make_hybrid_mesh``).  A collective call: every rank makes it, with
    the same arguments."""
    if replica is not None:
        return make_hybrid_mesh(replica=replica, data=data, model=model, device=device)
    n = dist.get_world_size()
    if model is None and data is None:
        data, model = 1, n
    elif model is None:
        model = n // data
    elif data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return _device_mesh((data, model), (AXIS_DATA, AXIS_MODEL), device)


def make_hybrid_mesh(replica: int, data: int | None = None, model: int | None = None,
                     device: str = "cuda"):
    """A (replica, data, model) mesh: the leading axis carries pure data
    parallelism only (the JAX package puts it on the slow links between
    slices).  Ranks fill the grid in order, replica outermost; nothing tells
    a process which host a rank is on, so the JAX slice-topology check has no
    counterpart."""
    n = dist.get_world_size()
    per_replica = n // replica
    if model is None and data is None:
        data, model = 1, per_replica
    elif model is None:
        model = per_replica // data
    elif data is None:
        data = per_replica // model
    if replica * data * model != n:
        raise ValueError(f"mesh {replica}x{data}x{model} != {n} ranks")
    return _device_mesh((replica, data, model), (AXIS_REPLICA, AXIS_DATA, AXIS_MODEL), device)


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    """The ``DeviceMesh`` of ranks ``arange(prod(shape))`` laid out as
    ``shape``: one subgroup a row of each axis, each created with
    ``TIMEOUT`` (every rank creates every group, in one order)."""
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.arange(math.prod(shape), dtype=torch.int).reshape(shape)
    rank, mine = dist.get_rank(), []
    for dim in range(len(shape)):
        for ranks in grid.movedim(dim, -1).reshape(-1, shape[dim]).tolist():
            group = dist.new_group(ranks, timeout=TIMEOUT)
            if rank in ranks:
                mine.append(group)
    return DeviceMesh.from_group(mine, torch.device(device).type, mesh=grid,
                                 mesh_dim_names=names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` (1 for an axis the mesh lacks).  ``mesh``
    is a ``DeviceMesh`` or, for the pure spec functions, a mapping of axis
    sizes such as ``{"data": 4, "model": 2}``."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(name, 1))
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names
    return mesh.get_coordinate()[names.index(name)] if name in names else 0


def model_group(mesh):
    """The process group of this rank's model axis: the ranks whose partial
    sums one all-reduce adds."""
    return mesh.get_group(AXIS_MODEL)


def _attn_specs(shard_heads: bool) -> Params:
    h = AXIS_MODEL if shard_heads else None
    return {
        "q_proj": {"kernel": P(None, None, h, None)},  # [L, D, N, H]
        "k_proj": {"kernel": P(None, None, h, None)},
        "v_proj": {"kernel": P(None, None, h, None)},
        "o_proj": {"kernel": P(None, h, None, None)},  # [L, N, H, D] → all-reduce on D
    }


def param_specs(config: DiaConfig) -> Params:
    """The spec tree of ``models.dia.init_params``'s tree: attention kernels
    on their head axis, the FFN on its hidden axis; embeddings, norms and
    the logits head (V = 1028) replicated."""
    mlp = {
        "wi_fused": {"kernel": P(None, None, None, AXIS_MODEL)},  # [L, D, 2, F]
        "wo": {"kernel": P(None, AXIS_MODEL, None)},  # [L, F, D] → all-reduce on D
    }
    return {
        "encoder": {
            "embedding": {"embedding": P(None, None)},
            "layers": {
                "pre_sa_norm": {"scale": P(None, None)},
                "self_attention": _attn_specs(True),
                "post_sa_norm": {"scale": P(None, None)},
                "mlp": dict(mlp),
            },
            "norm": {"scale": P(None)},
        },
        "decoder": {
            "embeddings": {"embedding": P(None, None, None)},
            "layers": {
                "pre_sa_norm": {"scale": P(None, None)},
                "self_attention": _attn_specs(True),
                "pre_ca_norm": {"scale": P(None, None)},
                "cross_attention": _attn_specs(True),
                "pre_mlp_norm": {"scale": P(None, None)},
                "mlp": dict(mlp),
            },
            "norm": {"scale": P(None)},
            "logits_dense": {"kernel": P(None, None, None)},
        },
    }


def map_specs(fn, specs: Params, params: Params, path: tuple = ()) -> Params:
    """``fn(spec, leaf, path)`` over the spec tree and the params tree, which
    must hold the same keys."""
    if set(specs) != set(params):
        raise ValueError(f"params at {'.'.join(path) or '<root>'} hold {sorted(params)}, the "
                         f"sharding rules {sorted(specs)}")
    return {k: map_specs(fn, s, params[k], path + (k,)) if isinstance(s, dict)
            else fn(s, params[k], path + (k,)) for k, s in specs.items()}


def fsdp_param_specs(config: DiaConfig, params: Params, mesh,
                     min_elements: int = 1 << 16) -> Params:
    """Fully sharded storage specs: the tensor-parallel plan plus a ``data``
    axis on one free dimension of every leaf of at least ``min_elements``
    (the largest free dimension that the data axis divides).  A pure
    function of the leaves' shapes and the data axis's size; ``mesh`` may be
    a mapping of axis sizes.  ``Trainer(mesh=)`` gathers each such leaf
    before use (``data_gather``) and keeps its moments shard-sized."""
    dsize = axis_size(mesh, AXIS_DATA)

    def add_data_axis(spec: P, leaf, path) -> P:
        shape = tuple(leaf.shape)
        if math.prod(shape) < min_elements or dsize <= 1:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        best = None
        for d, (size, axis) in enumerate(zip(shape, dims)):
            if axis is None and size % dsize == 0 and (best is None or size > shape[best]):
                best = d
        if best is None:
            return spec
        dims[best] = AXIS_DATA
        return P(*dims)

    return map_specs(add_data_axis, param_specs(config), params)


def self_cache_spec() -> P:
    """Self-attention cache [L, B, T, Nkv, H]: the head axis."""
    return P(None, None, None, AXIS_MODEL, None)


def cross_cache_spec() -> P:
    """Cross-attention cache [L, B, S, N, H]: the head axis."""
    return P(None, None, None, AXIS_MODEL, None)


def batch_spec(ndim: int, mesh=None) -> P:
    """The leading batch axis over data, and over (replica, data) on a mesh
    that has a replica axis."""
    batch_axes: Any = AXIS_DATA
    names = mesh if isinstance(mesh, Mapping) else getattr(mesh, "mesh_dim_names", ())
    if mesh is not None and AXIS_REPLICA in names:
        batch_axes = (AXIS_REPLICA, AXIS_DATA)
    return P(batch_axes, *([None] * (ndim - 1)))


def local_shard(x: torch.Tensor, spec: P, mesh, what: str = "tensor") -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each named dimension cut
    into as many equal parts as its axes hold ranks, the part at this rank's
    coordinate taken.  A new contiguous tensor on ``x``'s device (nothing
    keeps ``x`` alive); ``x`` itself where the spec shards nothing.  A
    dimension that does not divide raises, naming it."""
    out = x
    for dim, axis in enumerate(spec):
        axes = () if axis is None else axis if isinstance(axis, tuple) else (axis,)
        size = math.prod(axis_size(mesh, a) for a in axes)
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"{what}: dimension {dim} of shape {tuple(x.shape)} "
                             f"({x.shape[dim]}) does not divide over mesh axis {axis!r} "
                             f"({size} ranks)")
        index = 0
        for a in axes:
            index = index * axis_size(mesh, a) + axis_index(mesh, a)
        n = x.shape[dim] // size
        out = out.narrow(dim, index * n, n)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def shard_params(params: Params, mesh, specs: Params | None = None,
                 config: DiaConfig | None = None, fsdp: bool = False) -> Params:
    """Each rank's local shard of every leaf (``local_shard``) with the
    tensor-parallel layout; ``fsdp=True`` also splits storage over the data
    axis (``fsdp_param_specs``), a layout that ``Trainer(mesh=)`` takes and
    serving does not.  ``gather_params`` is the inverse.  Float tensors
    only: a packed or block-sparse kernel raises — shard the float tree,
    then quantize it under the mesh (``Dia.shard`` then
    ``Dia.quantize_int8`` / ``quantize_int4``), so that the row-parallel
    kernels' scales are taken over the whole K."""
    if specs is None:
        specs = fsdp_param_specs(config, params, mesh) if fsdp else param_specs(config)

    def one(spec, x, path):
        what = ".".join(path)
        if not torch.is_tensor(x):
            raise TypeError(f"{what}: a {type(x).__name__} cannot be sharded; shard the float "
                            f"tree, then quantize it under the mesh")
        return local_shard(x, spec, mesh, what)

    return map_specs(one, specs, params)


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``
    (``local_shard``'s), divisibility not checked; ``mesh`` may be a mapping
    of axis sizes."""
    out = list(shape)
    for dim, axis in enumerate(spec):
        for a in () if axis is None else axis if isinstance(axis, tuple) else (axis,):
            out[dim] //= axis_size(mesh, a)
    return tuple(out)


def _host_staged(x: torch.Tensor, group) -> bool:
    """gloo all-gathers and reduce-scatters host tensors only: a CUDA tensor
    goes through the host (NCCL takes it as it is)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim``, in rank
    order (a mesh axis's group: coordinate order).  A collective call."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if _host_staged(src, group):
        src = src.cpu()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` of ``group``, cut into as many blocks
    along ``dim`` as the group has ranks, this rank's block taken.  A
    collective call."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if _host_staged(src, group):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim).contiguous()


class _DataGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        # summed in float32, rounded once to the leaf's dtype
        return reduce_scatter_dim(grad.float(), ctx.dim, ctx.group).to(grad.dtype), None, None


def data_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """An FSDP leaf's whole block along ``dim`` from the data shards of
    ``group`` (the mesh's data axis), gathered before use.  Under autograd
    its backward is the reduce-scatter (sum) of the gradient, so the leaf's
    gradient arrives already summed over the data axis; the sum is taken in
    float32.  A collective call."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _DataGather.apply(x, dim, group)
    return all_gather_dim(x, dim, group)


@torch.no_grad()
def gather_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block under ``spec`` (``local_shard``'s
    inverse), detached (``x`` itself, detached, where ``spec`` shards nothing
    on this mesh).  A collective call."""
    for dim, axis in enumerate(spec):
        # local_shard numbers blocks outer axis first: gather the inner one first
        for a in reversed(() if axis is None else axis if isinstance(axis, tuple) else (axis,)):
            if axis_size(mesh, a) > 1:
                x = all_gather_dim(x, dim, mesh.get_group(a))
    return x.detach()


def gather_params(local: Params, mesh, specs: Params) -> Params:
    """The whole tree from every rank's local shards under ``specs``: the
    inverse of ``shard_params``, every rank getting every leaf whole.  A
    collective call."""
    return map_specs(lambda spec, x, path: gather_leaf(x, spec, mesh), specs, local)


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes the batch is split over (``batch_spec``): data, and replica
    on a hybrid mesh."""
    names = mesh.mesh_dim_names
    return tuple(a for a in (AXIS_REPLICA, AXIS_DATA) if a in names)


def shard_batch(tree, mesh):
    """Each rank's rows of every input: the leading axis over data (and
    replica)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    return local_shard(tree, batch_spec(tree.dim(), mesh), mesh, "batch")


def replicate(tree, mesh):
    """Replicated inputs: every rank already holds its own full copy, so the
    tree is returned as it is (the JAX function commits one to every device)."""
    return tree


def validate_divisibility(config: DiaConfig, model_size: int) -> list[str]:
    """The tensor-parallel plan's dimensions that the model-axis size does
    not divide (``shard_params`` raises on each of them)."""
    issues = []
    m = config.model
    checks = {
        "encoder heads": m.encoder.n_head,
        "decoder q heads": m.decoder.gqa_query_heads,
        "decoder kv heads": m.decoder.kv_heads,
        "cross heads": m.decoder.cross_query_heads,
        "encoder ffn": m.encoder.n_hidden,
        "decoder ffn": m.decoder.n_hidden,
    }
    for name, dim in checks.items():
        if dim % model_size != 0:
            issues.append(f"{name} ({dim}) not divisible by model axis ({model_size})")
    return issues


def warm_up(mesh, device) -> None:
    """One all-reduce on every group of the mesh: an NCCL communicator is
    created at its first collective, which must not happen inside a CUDA
    graph capture.  A collective call."""
    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device=device), group=mesh.get_group(name))


def capturable(group) -> bool:
    """Whether a CUDA graph can capture this group's collectives: NCCL's
    can; gloo's stage CUDA tensors through the host and cannot."""
    return dist.get_backend(group) == "nccl"


def checksum(arrays) -> int:
    """A CRC-32 of host numpy arrays: their dtypes, shapes and bytes."""
    crc = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        crc = zlib.crc32(a.tobytes(), zlib.crc32(repr((a.dtype.str, a.shape)).encode(), crc))
    return crc


def check_agree(mesh, arrays, device, what: str) -> None:
    """Raise unless every rank of the mesh holds the same ``arrays`` (host
    numpy arrays): an all-reduce of their checksum and its negation, max,
    over every axis.  A collective call."""
    crc = checksum(arrays)
    t = torch.tensor([crc, -crc], dtype=torch.int64, device=device)
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    if int(t[0]) != -int(t[1]):
        raise RuntimeError(f"the ranks of the mesh disagree on {what}")
