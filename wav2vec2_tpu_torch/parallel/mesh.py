"""Device mesh and sharding placements (counterpart of
`wav2vec2_tpu.parallel.mesh`).

**Process model.** The JAX package runs one controller over every device.
The port is SPMD, PyTorch's idiom: one process per device under
`torch.distributed` (launched by `torchrun --nproc-per-node N` or
`torch.multiprocessing.spawn`), each with the default process group
initialised. Every rank calls the entry point (`BatchAligner`,
`align_longform`, `make_train_step`'s step) with the same arguments, and
every rank returns the same full result: every row, in order, as the JAX
caller gets it from one call.

**Placements.** `make_mesh` builds a `DeviceMesh` with the axes
('data', 'model'). DTensor placements take the place of `NamedSharding`:
the batch is `(Shard(0), Replicate())` (`batch_sharding`), and the encoder
weights are tensor-parallel (Megatron's layout, per stacked layer
[L, ...]): the q/k/v kernels [L, H, H] shard the output axis over 'model'
(heads split across ranks), out_proj [L, H, H] shards the input axis, so
the attention block ends in one all-reduce; the FFN shards F in both of
its matmuls, one all-reduce; everything else (norms, convs, embeddings,
lm_head) is replicated. `param_shardings` is the JAX rule leaf for leaf
(`spec_for` gives the `PartitionSpec`-like tuple of axis names).

Under a mesh the forward runs on DTensors, so any placement computes the
same function, as any sharding does under GSPMD: on an int8 tree the
q/k/v leaves are `kernel_q`, which the rule gives the bias spec
(None, 'model'), sharding their input axis, and DTensor inserts the
partial sum that spec needs. Plain tensors met inside the forward (masks,
position tables, constants) count as replicated
(`implicit_replication`). The collectives on the model axis are
all-reduce (a partial sum made whole) and all-gather (a shard made
whole); gloo carries both on CUDA tensors.

**Ops run inside `local_map`** (each sees its rank's local tensors; the
batch rows of a rank are independent of every other rank's, so none of
them moves data):
- `ops.flash_attention.flash_attention` (K5): q, k, v and q_pos
  (Shard(0), Shard(1)), batch over 'data' and heads over 'model'; rel_r
  Shard(0) over 'model' (heads first); the mask Shard(0) over 'data'; the
  output (Shard(0), Shard(1)). The counterpart of the JAX launch inside
  `jax.shard_map`: each rank's K5 sees its [B/dp, NH/tp, T_pad, hd] tile.
- `ops.viterbi_cuda.viterbi_batch` (K1–K4 by `select_tier`) and
  `ops.evidence.evidence_batch`, with `BatchAligner`'s on-device
  normalisation and log-softmax before them: batch Shard(0) over 'data',
  replicated over 'model'. The kernels write through raw pointers, so
  their wrappers refuse a DTensor.
- the attention cores on each rank's (rows, heads) tile (`head_local`):
  softmax attention (with WavLM's [B, H, T, T] bias), SEW-D's
  disentangled core and the conformer's factorized core (its per-head
  `pos_bias_u/v` and `linear_pos` split over 'model' with the heads):
  their relative shifts are strided views and gathers DTensor has no rule
  for. WavLM's bucket lookup runs whole on every rank (`whole_local`): an
  index by a plain tensor.
- the frontends (`batch_local`): the conv feature extractor, whose group
  and channel norms take `var_mean`, which the card's torch (2.11) has no
  sharding rule for, and the mel frontend, whose frame view (`unfold`) has
  none in any version. The encoder's convolutions (the grouped positional
  one, the conformer's depthwise one) run on DTensors: the batch is their
  only sharded axis.
- the CTC loss (`parallel.train`): per row, on each rank's rows
  (`F.ctc_loss` and the `index_put` of optax's rows), then the mean over
  the global batch (an all-reduce over 'data').
- int8 serving's `torch._int_mm` (`contract_local`): on each rank's rows
  and the weight's 'model' piece, whichever axis the rule split (an int8
  tree's q/k/v `kernel_q` is split on its input axis, as JAX's rule says);
  a split input axis gives an int32 partial sum, which one all-reduce makes
  whole, exactly.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")
_ATTENTION = {"q_proj", "k_proj", "v_proj", "out_proj"}
_CONFORMER_ATTENTION = {"linear_q", "linear_k", "linear_v", "linear_pos"}
_SEWD_ATTENTION = {"query_proj", "key_proj", "value_proj"}
_FFN_DENSES = {"intermediate_dense", "output_dense"}


def make_mesh(n_devices: int | None = None, data: int | None = None, model: int = 1,
              device: str = "cuda"):
    """A ('data', 'model') `DeviceMesh` over the initialised default process
    group: rank r sits at (r // model, r % model). On `cuda` each rank uses
    the card `torch.cuda.current_device()` names (set it before the call
    under `torchrun`); with no card this raises, there is no CPU fall-back.
    `device="cpu"` builds the mesh for gloo on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): torch sees no CUDA device; "
                           "pass device='cpu' to build a gloo mesh on the CPU")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    n = n_devices or dist.get_world_size()
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a world of {dist.get_world_size()}")
    return init_device_mesh(device, (data, model), mesh_dim_names=MESH_AXES)


def mesh_size(mesh) -> int:
    """The number of ranks in `mesh` (1 for None)."""
    return 1 if mesh is None else mesh.size()


def axis_size(mesh, axis: str) -> int:
    """The size of `mesh`'s axis `axis` (1 for None)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))


def batch_sharding(mesh) -> tuple:
    """The batch's placements: rows over 'data', whole on 'model'. On a
    mesh whose 'data' axis is 1 the rows are whole (Replicate): the same
    local tensors, and DTensor's view rules refuse a Shard of a one-row
    batch ([1, T, H] → [T, H] in a matmul)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0) if axis_size(mesh, "data") > 1 else Replicate(), Replicate())


def replicated(mesh) -> tuple:
    """Whole on every rank."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def spec_for(keys: tuple, ndim: int) -> tuple:
    """The JAX rule (`wav2vec2_tpu.parallel.mesh.param_shardings`) for one
    leaf: its key path and rank → the `PartitionSpec` as a tuple of axis
    names (None = not sharded; () = replicated)."""
    keys = set(keys)
    if "layers" not in keys:
        return ()
    if _ATTENTION & keys:
        # only the four projections TP-shard; other attention params (WavLM
        # gru_rel_pos_*) replicate
        if "out_proj" in keys:
            return (None, "model", None) if ndim == 3 else ()
        if "kernel" in keys:
            return (None, None, "model")
        return (None, "model")  # q/k/v bias, and an int8 tree's kernel_q/scale
    if _CONFORMER_ATTENTION & keys:
        return (None, None, "model") if "kernel" in keys else (None, "model")
    if "linear_out" in keys:
        return (None, "model", None) if ndim == 3 else ()
    if {"pos_bias_u", "pos_bias_v"} & keys:
        return (None, "model", None)
    if _SEWD_ATTENTION & keys:
        return (None, None, "model") if "kernel" in keys else (None, "model")
    if "feed_forward" in keys or ("attention" not in keys and _FFN_DENSES & keys):
        # wav2vec2's FFN under feed_forward.*; SEW-D's BERT-style FFN at layer level
        if "intermediate_dense" in keys:
            return (None, None, "model") if ndim == 3 else (None, "model")
        if "output_dense" in keys and "kernel" in keys:
            return (None, "model", None)
        return ()
    if "output_dense" in keys and "attention" in keys:
        # SEW-D's attention output projection
        return (None, "model", None) if "kernel" in keys else ()
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def placements_for(spec: tuple) -> tuple:
    """A spec tuple → the placements on ('data', 'model'): axis i named
    'model' becomes Shard(i) on the model dimension."""
    from torch.distributed.tensor import Replicate, Shard

    model = next((Shard(i) for i, name in enumerate(spec) if name == "model"),
                 Replicate())
    return (Replicate(), model)


def param_shardings(params: dict, mesh) -> dict:
    """The placements of every leaf of `params` on `mesh`."""
    return _map_with_path(lambda path, x: placements_for(spec_for(path, x.ndim)), params)


def mesh_device(mesh) -> torch.device:
    """The torch device this rank's shards of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_chunk(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the full tensor `x` (the same on every rank) at
    `placements`: taken locally, with no collective."""
    coord = mesh.get_coordinate()
    for dim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(dim)
            if x.shape[p.dim] % n:
                raise ValueError(f"axis {p.dim} of a {tuple(x.shape)} tensor does not "
                                 f"split over {MESH_AXES[dim]!r}={n}")
            x = x.chunk(n, dim=p.dim)[coord[dim]]
    return x.contiguous()


def distribute(x: torch.Tensor, mesh, placements):
    """The full tensor `x`, which every rank holds alike, as a DTensor at
    `placements` on `mesh`: each rank keeps its own piece (no scatter, which
    gloo lacks on CUDA tensors)."""
    from torch.distributed.tensor import DTensor

    x = torch.as_tensor(x).to(mesh_device(mesh))
    return DTensor.from_local(_local_chunk(x, mesh, placements), mesh, tuple(placements),
                              run_check=False)


def shard_params(params: dict, mesh) -> dict:
    """The tree as DTensors on `mesh`, each leaf at its `param_shardings`
    placement."""
    return _map_with_path(
        lambda path, x: distribute(x, mesh, placements_for(spec_for(path, x.ndim))),
        params)


def place_params(params: dict, mesh) -> dict:
    """Caller-placed params kept as they are: DTensor leaves keep their
    placement and dtype, any other leaf is replicated on `mesh`."""
    return _map_with_path(
        lambda path, x: x if is_dtensor(x) else distribute(x, mesh, replicated(mesh)),
        params)


def distribute_rows(mesh, *arrays):
    """Each full batch array (numpy or tensor; rows a multiple of the
    'data' size) as a DTensor at `batch_sharding`."""
    return tuple(distribute(torch.as_tensor(a), mesh, batch_sharding(mesh)) for a in arrays)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full(x):
    """A DTensor made whole on every rank (a plain tensor as it is), by c10d
    collectives on the mesh's groups: an all-gather for each axis it is
    sharded over (the inner axis first), an all-reduce for a partial sum.
    DTensor's own `full_tensor` gathers through functional collectives,
    which gloo does not carry on CUDA tensors."""
    if not is_dtensor(x):
        return x
    mesh, local = x.device_mesh, x.to_local()
    for dim in reversed(range(mesh.ndim)):
        p, group = x.placements[dim], mesh.get_group(dim)
        if p.is_shard():
            parts = [torch.empty_like(local) for _ in range(mesh.size(dim))]
            dist.all_gather(parts, local.contiguous(), group=group)
            local = torch.cat(parts, dim=p.dim)
        elif p.is_partial():
            local = local.clone()
            dist.all_reduce(local, group=group)
    return local


@contextlib.contextmanager
def dtensor_no_grad():
    """No autograd, for a forward on DTensors inside `torch.inference_mode`:
    a view of a DTensor made in inference mode fails ("Cannot set
    version_counter for inference tensor"), so that mode is turned off and
    grad mode with it."""
    with torch.inference_mode(False), torch.no_grad():
        yield


def _placed(mesh, kind):
    """(in, grad) placements of one `local_map` argument on `mesh`: "rows"
    (`batch_sharding`), "tile" (rows and heads, Shard(1) over 'model'), "whole"
    (replicated, its gradient whole on every rank), a weight of a batch-
    local op ("weight": whole, its gradient a partial sum over 'data'), or
    a weight of a head-local op: its heads axis (an int) sharded over
    'model', or None, whole, its gradient summed over every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = batch_sharding(mesh)
    if kind == "rows":
        return rows, rows
    if kind == "tile":
        return (rows[0], Shard(1)), (rows[0], Shard(1))
    if kind == "whole":
        return (Replicate(), Replicate()), (Replicate(), Replicate())
    if kind == "weight":
        return (Replicate(), Replicate()), (Partial(), Replicate())
    if kind is None:
        return (Replicate(), Replicate()), (Partial(), Partial())
    return (Replicate(), Shard(kind)), (Partial(), Shard(kind))


def _local_map(fn, args, kinds, outputs, out_kind):
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten

    mesh = next(x.device_mesh for x in tree_flatten(args)[0] if is_dtensor(x))
    ins, grads = [], []
    for arg, kind in zip(args, kinds):
        if isinstance(kind, dict):  # a dict of weights, a kind each
            leaves = [(x, kind[k]) for k in arg for x in tree_flatten(arg[k])[0]]
        else:
            leaves = [(x, kind) for x in tree_flatten(arg)[0]]
        for x, k in leaves:
            placed = _placed(mesh, k) if is_dtensor(x) else (None, None)
            ins.append(placed[0])
            grads.append(placed[1])
    out = _placed(mesh, out_kind)[0]
    return local_map(fn, out_placements=(out,) * outputs, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _has_dtensor(args) -> bool:
    from torch.utils._pytree import tree_flatten

    return any(is_dtensor(x) for x in tree_flatten(args)[0])


def batch_local(fn, *args, outputs: int = 1):
    """`fn(*args)` run by `local_map` on each rank's rows: a DTensor
    argument (or leaf of a dict argument) sharded over 'data' is taken at
    `batch_sharding`, any other DTensor as a whole weight (its gradient a
    partial sum over 'data'); the `outputs` tensors come back at
    `batch_sharding`. Without a DTensor argument it is `fn(*args)`. For the
    per-row ops DTensor has no rule for, and for the kernels, which must see
    plain tensors."""
    if not _has_dtensor(args):
        return fn(*args)
    from torch.utils._pytree import tree_flatten

    kinds = []
    for arg in args:
        leaves = [x for x in tree_flatten(arg)[0] if is_dtensor(x)]
        rows = leaves and leaves[0].placements[0].is_shard(0)
        kinds.append("rows" if rows else "weight")
    return _local_map(fn, args, kinds, outputs, "rows")


def whole_local(fn, *args):
    """`fn(*args)` run by `local_map` on whole tensors: for an op of the
    weights alone (WavLM's bias table lookup), every DTensor argument and
    the one output replicated, gradients whole on every rank."""
    if not _has_dtensor(args):
        return fn(*args)
    return _local_map(fn, args, ("whole",) * len(args), 1, "whole")


def head_local(fn, tiles: tuple, rows: tuple, weights: dict, head_axes: dict):
    """`fn(*tiles, *rows, weights)` run by `local_map` on each rank's
    (rows, heads) tile, the layout of K5's launch: `tiles` [B, NH, ...] at
    (Shard(0), Shard(1)), `rows` at `batch_sharding`, each weight (a dict
    of tensors) split over 'model' along its heads axis `head_axes[name]`,
    or whole where it has none; one output at (Shard(0), Shard(1)).
    Without a DTensor it is the plain call."""
    args = (*tiles, *rows, weights)
    if not _has_dtensor(args):
        return fn(*args)
    kinds = ("tile",) * len(tiles) + ("rows",) * len(rows)
    return _local_map(fn, args, kinds + ({k: head_axes.get(k) for k in weights},), 1,
                      "tile")


def contract_local(fn, a, b):
    """`fn(a, b)`, a product a [M, K] · b [K, N] DTensor has no rule for
    (`torch._int_mm`), run by `local_map` on each rank's pieces: a's rows
    keep their 'data' placement and b is whole over 'data'; over 'model',
    b's columns split gives the output's columns split, b's K split takes
    a's K split and gives a partial sum, and a whole b takes a whole a.
    Without a DTensor it is the plain call."""
    if not _has_dtensor((a, b)):
        return fn(a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (a if is_dtensor(a) else b).device_mesh
    rows = a.placements[0] if is_dtensor(a) else Replicate()
    b_model = b.placements[1] if is_dtensor(b) else Replicate()
    if b_model.is_shard(1):
        a_model, out_model = Replicate(), Shard(1)
    elif b_model.is_shard(0):
        a_model, out_model = Shard(1), Partial()
    else:
        a_model, out_model = Replicate(), Replicate()
    ins = tuple((place if is_dtensor(x) else None) for x, place in
                ((a, (rows, a_model)), (b, (Replicate(), b_model))))
    return local_map(fn, out_placements=((rows, out_model),), in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)(a, b)
