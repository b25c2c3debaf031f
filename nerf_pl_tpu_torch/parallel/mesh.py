"""The (data, model) mesh of a torch.distributed world, and the tensor
parallel (Megatron) layout of the NeRF MLP on its `model` axis.

Port of nerf_pl_tpu/parallel/mesh.py. JAX lays its devices out as
reshape(num_data, num_model) and lets GSPMD insert the collectives that
the params' PartitionSpecs imply. Here a rank is a process, so the mesh is
a pair of process groups: rank r of the world has data index
r // num_model and model index r % num_model. Its data group holds the
ranks of its model index (the ray store, the batch and the gradient
all-reduce are split over it); its model group holds the ranks of its
data index (the MLP's hidden width is split over it). A PartitionSpec is
a tuple naming, dim by dim, the axis that dim is split over: () whole,
(None, "model") split columns, ("model",) a bias split with them,
("model", None) split rows.

`TensorParallel` runs the Megatron MLP's collectives as autograd
Functions, each with its conjugate as the backward: copy to the model
axis (identity; all-reduce), reduce from it (all-reduce; identity),
gather from it (gather; this rank's slice) and scatter to it (this rank's
slice; gather). A gather is an all-reduce of zero-padded blocks, as
`dist.gather_rows`: gloo has no all_gather of CUDA tensors, so one code
path serves NCCL ranks and gloo ranks sharing a card.

torch only, like `dist.py`: nothing of jax or of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .. import dist as pdist

MODEL = "model"
Spec = tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, model) mesh. A group is None where
    its axis has one rank (no collective runs over it)."""
    data_group: Any       # the ranks of this model index
    model_group: Any      # the ranks of this data index
    num_data: int
    num_model: int
    data_index: int
    model_index: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.num_data, "model": self.num_model}


def make_mesh(group=None, num_model: int = 1) -> Mesh:
    """The (world // num_model, num_model) mesh of `group`'s ranks, laid
    out as JAX's reshape(num_data, num_model). With num_model 1 the data
    group is `group` itself and no group is made. Otherwise every rank of
    the default group must call this in the same order: it makes one data
    group per model index and one model group per data index
    (torch.distributed.new_group is collective over the default group),
    each with `group`'s backend."""
    world, rank = pdist.world_of(group), pdist.rank_of(group)
    if num_model < 1 or world % num_model:
        raise ValueError(f"a model axis of {num_model} does not divide the "
                         f"world of {world} ranks")
    num_data = world // num_model
    data_index, model_index = divmod(rank, num_model)
    if num_model == 1:
        return Mesh(group, None, num_data, 1, data_index, 0)
    ranks = dist.get_process_group_ranks(group)
    backend = pdist.backend_of(group)
    data_group = model_group = None
    if num_data > 1:
        for m in range(num_model):
            g = dist.new_group([ranks[d * num_model + m]
                                for d in range(num_data)], backend=backend)
            if m == model_index:
                data_group = g
    for d in range(num_data):
        g = dist.new_group(ranks[d * num_model:(d + 1) * num_model],
                           backend=backend)
        if d == data_index:
            model_group = g
    return Mesh(data_group, model_group, num_data, num_model, data_index,
                model_index)


# ------------------------------------------------------------------ specs

def tensor_parallel_pspecs(params: Dict[str, Any],
                           model_size: int) -> Dict[str, Any]:
    """Specs splitting one NeRF MLP over the model axis (the JAX rules).

    The trunk alternates: even layers column-parallel (w's output dim and
    b split), odd layers row-parallel (w's input dim split, b whole). A
    layer whose dim does not divide by the axis (a skip concat's input,
    say) stays whole. xyz_final is column-parallel; the heads are whole.
    Only each layer's w.shape is read."""
    specs: Dict[str, Any] = {}
    for name, layer in params.items():
        w = layer["w"]
        spec = {"w": (), "b": ()}
        if name.startswith("xyz_") and name != "xyz_final":
            i = int(name.split("_")[1])
            if i % 2 == 0 and w.shape[1] % model_size == 0:
                spec = {"w": (None, MODEL), "b": (MODEL,)}
            elif i % 2 == 1 and w.shape[0] % model_size == 0:
                spec = {"w": (MODEL, None), "b": ()}
        elif name == "xyz_final" and w.shape[1] % model_size == 0:
            spec = {"w": (None, MODEL), "b": (MODEL,)}
        specs[name] = spec
    return specs


def model_pspecs(params: Dict[str, Any], model_size: int,
                 tensor_parallel: bool) -> Dict[str, Any]:
    """Specs of the whole {'nerf_coarse', 'nerf_fine'} parameter tree."""
    out = {}
    for model_name, model_params in params.items():
        if tensor_parallel and model_size > 1:
            out[model_name] = tensor_parallel_pspecs(model_params, model_size)
        else:
            out[model_name] = {k: {"w": (), "b": ()} for k in model_params}
    return out


def split_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the model axis, or None."""
    return spec.index(MODEL) if MODEL in spec else None


# ------------------------------------------------------------ collectives

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return pdist.all_reduce_sum([x], group)[0]


def split(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of x along dim (a new contiguous tensor)."""
    n = x.shape[dim] // mesh.num_model
    return x.narrow(dim, mesh.model_index * n, n).clone(
        memory_format=torch.contiguous_format)


def gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's blocks of x along dim, in model order, on every
    rank of it: each writes its block into zeros and the buffers are
    summed (a block plus zeros is the block, bit for bit)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.num_model
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.model_index * n, n).copy_(x)
    return _all_reduce(buf, mesh.model_group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.dim, ctx.mesh), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return split(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim, ctx.mesh), None, None


class TensorParallel:
    """The NeRF MLPs' layout on a mesh's model axis.

    `specs` is `model_pspecs`' tree ({model: {layer: {"w", "b": spec}}}).
    The MLPs of a tree share one config, so a layer has one spec in all
    of them (`kind`). Params and their optimizer moments are held as
    this rank's blocks; a leaf is found by its checkpoint path, whose last
    three parts are (model, layer, leaf)."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Any]):
        self.mesh = mesh
        self.specs = specs
        self.layers = next(iter(specs.values()))

    def kind(self, layer: str) -> Optional[str]:
        """"column", "row", or None (whole) for a layer of the MLP."""
        w = self.layers[layer]["w"]
        return {(None, MODEL): "column", (MODEL, None): "row"}.get(w)

    # the Megatron MLP's collectives (differentiable)
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last dim of an activation split over the axis."""
        return _GatherFromModel.apply(x, x.dim() - 1, self.mesh)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole activation's last dim."""
        return _ScatterToModel.apply(x, x.dim() - 1, self.mesh)

    def gather_params(self, mlp: Dict[str, Dict[str, torch.Tensor]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """One MLP's whole weights from its blocks, differentiably: the
        backward hands each rank its block of the whole gradient (a custom
        kernel's, which every rank of the model group computes alike)."""
        out = {}
        for layer, leaves in mlp.items():
            out[layer] = {}
            for leaf, x in leaves.items():
                dim = split_dim(self.layers[layer][leaf])
                out[layer][leaf] = (x if dim is None else
                                    _GatherFromModel.apply(x, dim, self.mesh))
        return out

    # whole trees <-> blocks, by checkpoint path (not differentiable)
    def dim_of(self, path: str) -> Optional[int]:
        parts = path.split("/")
        if len(parts) < 3 or parts[-3] not in self.specs:
            return None
        spec = self.specs[parts[-3]].get(parts[-2], {}).get(parts[-1])
        return None if spec is None else split_dim(spec)

    def shard_leaf(self, path: str, x):
        """This rank's block of a whole leaf (other leaves as they are)."""
        dim = self.dim_of(path)
        return x if dim is None else split(x, dim, self.mesh)

    def gather_leaf(self, path: str, x):
        """The whole leaf from this rank's block (collective over the
        model group; other leaves as they are)."""
        dim = self.dim_of(path)
        return x if dim is None else gather(x, dim, self.mesh)
