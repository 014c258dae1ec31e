"""A data axis and a model axis inside one HWA replica (the reference's
``(replica, data, model)`` mesh under its mesh-native driver).

A :class:`Par` is one rank's place in its replica: the replica's ranks
split the batch over the ``data`` axis and the layers over the ``model``
axis, and hold each parameter leaf as the block the sharding rules give
them (``sharding.rules``; :class:`LeafPlace` per leaf). The model code
takes a ``par`` and makes the parallelism explicit, Megatron's way, with
the collectives as ``torch.autograd.Function``\\ s over the mesh's process
groups (``launch.mesh.ReplicaMesh``):

- :meth:`Par.copy_to_model`: identity forward, a sum over ``model`` in the
  backward, at the input of a column-parallel product (its input's
  gradient is partial on each model rank);
- :meth:`Par.reduce_from_model`: a sum over ``model`` forward, identity
  backward, at the output of a row-parallel product;
- :meth:`Par.prepare`: before a layer uses them, the leaves split over the
  data axes (FSDP's ``embed`` dim) are all-gathered, their gradient
  reduce-scattered in the backward as a mean over ``data``; a leaf whose
  rule fell through to ``head_dim`` is all-gathered over ``model``;
- :meth:`Par.gather_leaves`: the leaves a layer names
  (``transformer.model_gathers``: the recurrent cells' input side, the
  expert-parallel layer's router and shared experts) all-gathered over
  ``model``, their gradient summed over it where each rank's use is a
  part of the whole;
- :meth:`Par.scatter_model` / :meth:`Par.gather_blocks`: an activation's
  block along a dim (the backward all-gathers) and the blocks gathered
  back whole (the backward slices), around the expert-parallel
  dispatch and around the heads of an sLSTM cell.

The other data-axis half, the mean over ``data`` of the gradients of
leaves no data axis splits, is :meth:`Par.data_mean`, after the backward.
Sums go through ``ReplicaMesh.psum``: the model axis's partials in f32,
rounded once to the activations' dtype; the data mean in the gradients'
own dtypes. Gathers move bytes (``uint8`` views), exact for any dtype.

Which configs reach the ``head_dim`` fall-through: at ``--tp 2`` none of
the dense and MoE configs, smoke or published; at ``--tp 4`` the smoke
configs with 2 kv heads (granite-3-2b, gemma2-27b, stablelm-12b,
command-r-35b, granite-moe); at ``--tp 16`` the published ones with 8
(granite-3-2b, stablelm-12b, command-r-35b, granite-moe). The q heads
divide in every published config up to ``--tp 16``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.sharding.rules import entry_axes


@dataclasses.dataclass(frozen=True)
class LeafPlace:
    """How one leaf splits inside a replica: ``spec`` one entry a dim (an
    axis name, a tuple of them, or None), ``dims`` its logical names."""
    spec: tuple
    dims: tuple

    def axes(self, i: int) -> tuple[str, ...]:
        return entry_axes(self.spec[i]) if i < len(self.spec) else ()

    def unstacked(self) -> "LeafPlace":
        """The place of one layer of a stacked leaf (its ``layers`` dim
        dropped)."""
        return LeafPlace(self.spec[1:], self.dims[1:])


def places_tree(params, flat_specs, flat_dims):
    """A tree shaped like ``params`` with a :class:`LeafPlace` a leaf."""
    flat, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        LeafPlace(tuple(sp) + (None,) * (x.dim() - len(sp)), tuple(d))
        for x, sp, d in zip(flat, flat_specs, flat_dims)])


def blocks_of(tree, places, mesh, rank: int | None = None):
    """Rank ``rank``'s blocks of a whole tree (views; this rank's by
    default): each split dim narrowed to the rank's row-major coordinate
    along its axes."""
    c = mesh.coords(rank)
    flat, treedef = tree_flatten(tree)
    pl, _ = tree_flatten(places)
    out = []
    for x, p in zip(flat, pl):
        for i in range(x.dim()):
            axes = p.axes(i)
            n = mesh.size(axes) if axes else 1
            if n > 1:
                coord = 0
                for a in axes:
                    coord = coord * mesh.shape[a] + c[a]
                w = x.shape[i] // n
                x = x.narrow(i, coord * w, w)
        out.append(x)
    return tree_unflatten(treedef, out)


def experts_split(places, model_axes=("model",)) -> bool:
    """Whether the rules behind ``places`` (a :class:`LeafPlace` tree)
    split the MoE experts over ``model``: the layer is then the
    expert-parallel one (``moe.moe_forward_ep``)."""
    return any("experts" in p.dims and set(model_axes)
               & set(p.axes(p.dims.index("experts")))
               for p in tree_flatten(places)[0])


def _level_index(mesh, axes) -> int:
    lv = mesh.level(axes)
    return lv.ranks.index(mesh.rank)


def _gather_bytes(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``x`` over a level, ``(n, *x.shape)`` in rank order,
    moved as bytes."""
    x = x.contiguous()
    g = mesh.all_gather(x.reshape(-1).view(torch.uint8), axes)
    return g.view(x.dtype).reshape((g.shape[0],) + tuple(x.shape))


def _psum_f32(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over a level in f32, in ``x``'s dtype (a new
    tensor)."""
    return mesh.psum(x.detach().to(torch.float32, copy=True), axes) \
        .to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_f32(ctx.mesh, g, ctx.axes), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum_f32(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over a level (blocks in rank order). The
    backward hands each rank its block of the gradient: summed over the
    level first when each rank's gradient of the whole is a partial one
    (``partial``), then times ``scale``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, partial, scale):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.partial, ctx.scale = partial, scale
        ctx.index, ctx.width = _level_index(mesh, axes), x.shape[dim]
        ctx.x_dtype = x.dtype
        g = _gather_bytes(mesh, x, axes)
        return torch.cat(list(g.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.mesh.psum(g.to(torch.float32, copy=True), ctx.axes)
        block = g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width)
        if ctx.scale != 1.0:
            block = block.to(torch.float32) * torch.tensor(
                ctx.scale, dtype=torch.float32, device=g.device)
        return block.to(ctx.x_dtype), None, None, None, None, None


class _Scatter(torch.autograd.Function):
    """The rank's block along ``dim`` of a tensor every rank of a level
    holds whole; the backward all-gathers the blocks' gradients, so the
    whole tensor's gradient is whole on every rank again (Megatron's
    sequence-parallel scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = mesh.size(axes)
        w = x.shape[dim] // n
        return x.narrow(dim, _level_index(mesh, axes) * w, w).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        got = _gather_bytes(ctx.mesh, g, ctx.axes)
        return torch.cat(list(got.unbind(0)), dim=ctx.dim), None, None, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` (in its dtype)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale: float):
    return x if scale == 1.0 else _ScaleGrad.apply(x, scale)


class Par:
    """One rank's place inside its replica. ``mesh`` is the rank's
    ``launch.mesh.ReplicaMesh``; ``data_axes``/``model_axes`` the
    replica's inner axes (those of size 1 are dropped); ``places`` the
    :class:`LeafPlace` tree of the parameters; ``cfg`` the model."""

    def __init__(self, mesh, cfg, places, data_axes=("data",),
                 model_axes=("model",)):
        self.mesh, self.cfg, self.places = mesh, cfg, places
        self.data_axes = tuple(a for a in data_axes
                               if mesh.shape.get(a, 1) > 1)
        self.model_axes = tuple(a for a in model_axes
                                if mesh.shape.get(a, 1) > 1)
        self.dp = mesh.size(self.data_axes)
        self.tp = mesh.size(self.model_axes)
        self.dp_index = (_level_index(mesh, self.data_axes)
                         if self.dp > 1 else 0)
        self.tp_index = (_level_index(mesh, self.model_axes)
                         if self.tp > 1 else 0)
        # the head-parallel attention: q heads split over the model ranks
        # (the rules split ``heads`` exactly when they divide)
        self.heads_split = self.tp > 1 and cfg.n_heads % self.tp == 0
        self.expert_parallel = (places is not None and self.tp > 1
                                and experts_split(places, self.model_axes))

    # --------------------------------------------------- layouts

    def splits(self, n: int) -> bool:
        """Whether a ``model``-ruled dim of size ``n`` splits."""
        return self.tp > 1 and n % self.tp == 0

    # ---------------------------------------------- collectives

    def copy_to_model(self, x):
        if self.tp == 1:
            return x
        return _CopyToModel.apply(x, self.mesh, self.model_axes)

    def reduce_from_model(self, x):
        if self.tp == 1:
            return x
        return _ReduceFromModel.apply(x, self.mesh, self.model_axes)

    def scatter_model(self, x, dim: int):
        """The rank's block along ``dim`` of an activation every model
        rank holds whole (:class:`_Scatter`: an all-gather in the
        backward)."""
        return _Scatter.apply(x, self.mesh, self.model_axes, dim)

    def gather_blocks(self, x, dim: int):
        """Every model rank's block of an activation along ``dim``, in
        rank order: the whole tensor on every rank. Its backward hands the
        rank its block of the gradient, with no sum: the gradient of a
        whole activation is whole on every model rank."""
        return _Gather.apply(x, self.mesh, self.model_axes, dim, False, 1.0)

    def gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """Every model rank's ``x``, ``(tp, *x.shape)``: no gradient."""
        return _gather_bytes(self.mesh, x.detach(), self.model_axes)

    def prepare(self, tree, places):
        """The leaves of ``tree`` (this rank's blocks; ``places`` their
        :class:`LeafPlace`\\ s, unstacked to match) ready for use: each dim
        split over the data axes all-gathered, with a mean reduce-scatter
        over ``data`` in the backward (FSDP); a ``head_dim`` split over
        ``model`` (the rules' fall-through when the heads do not divide)
        all-gathered, its gradient summed over ``model`` when the heads
        are split (each rank's use is then a partial one) and sliced when
        they are not."""
        flat, treedef = tree_flatten(tree)
        pl, _ = tree_flatten(places)
        out = []
        inv_dp = 1.0 / self.dp
        for x, p in zip(flat, pl):
            for i in range(x.dim()):
                axes = p.axes(i)
                if not axes or self.mesh.size(axes) == 1:
                    continue
                if set(axes) <= set(self.data_axes):
                    x = _Gather.apply(x, self.mesh, axes, i, True, inv_dp)
                elif p.dims[i] == "head_dim":
                    x = _Gather.apply(x, self.mesh, axes, i,
                                      self.heads_split, 1.0)
            out.append(x)
        return tree_unflatten(treedef, out)

    def gather_leaves(self, tree, places, leaves: dict):
        """The leaves of a layer named by ``leaves`` (sub-tree -> {leaf:
        partial}) all-gathered along their dims split over ``model``
        (:class:`_Gather`); ``partial`` where each model rank's use of the
        whole leaf is a part of the whole use (its gradient is summed over
        ``model`` before the rank takes its block), not where every rank
        makes the same, whole use of it (the block is sliced). Returns the
        tree with those leaves replaced."""
        if self.tp == 1 or not leaves:
            return tree
        out = dict(tree)
        for sub, names in leaves.items():
            if sub not in tree:
                continue
            out[sub] = dict(tree[sub])
            for name, partial in names.items():
                if name not in tree[sub]:
                    continue
                x, p = tree[sub][name], places[sub][name]
                for i in range(x.dim()):
                    if self.model_split(p.axes(i)):
                        x = _Gather.apply(x, self.mesh, p.axes(i), i,
                                          partial, 1.0)
                out[sub][name] = x
        return out

    def model_split(self, axes) -> bool:
        """Whether a dim placed on ``axes`` is split over ``model``."""
        return bool(axes) and set(axes) <= set(self.model_axes) \
            and self.mesh.size(axes) > 1

    def model_split_dims(self, place) -> int:
        """How many dims of a leaf (its :class:`LeafPlace`) ``model``
        splits (0 or 1)."""
        return sum(1 for i in range(len(place.spec))
                   if self.model_split(place.axes(i)))

    def data_sharded(self) -> list[bool]:
        """Per leaf (flatten order): whether a data axis splits it (its
        gradient is then averaged over ``data`` by :meth:`prepare`'s
        backward)."""
        pl, _ = tree_flatten(self.places)
        return [any(set(p.axes(i)) & set(self.data_axes)
                    for i in range(len(p.spec))) for p in pl]

    def data_mean(self, grads, loss, skip=None):
        """The data-axis mean of a train step: the gradients of the leaves
        no data axis splits (``skip`` marks the others) and the loss, one
        buffer a dtype (the loss with the f32 gradients), each SUMMED over
        ``data`` in its dtype (one reduction, the hypercube chain of
        ``ReplicaMesh.psum``) and scaled by the reciprocal of the data
        size: the mean, as the reference's ``pmean`` over its gradients'
        dtypes. The gradients come back as views of those buffers.
        Returns (grads, loss)."""
        if self.dp == 1:
            return grads, loss
        skip = skip or [False] * len(grads)
        groups: dict = {torch.float32: []}
        for i, (g, s) in enumerate(zip(grads, skip)):
            if not s:
                groups.setdefault(g.dtype, []).append(i)
        out = list(grads)
        for dt, idx in groups.items():
            parts = [grads[i].reshape(-1) for i in idx]
            if dt == torch.float32:
                parts.append(loss.detach().reshape(1).to(dt))
            # the mean over data: the sum scaled by the reciprocal of the
            # data size (1/2 exact for two ranks), as the reference's pmean
            flat = self.mesh.psum(torch.cat(parts), self.data_axes).mul_(
                torch.tensor(1.0 / self.dp, dtype=dt, device=loss.device))
            off = 0
            for i in idx:
                out[i] = flat[off:off + grads[i].numel()].view(
                    grads[i].shape)
                off += grads[i].numel()
            if dt == torch.float32:
                loss = flat[-1]
        return out, loss

    def data_mean_groups(self, dtypes, skip) -> int:
        """How many reductions :meth:`data_mean` makes a step: one a
        dtype of the leaves it reduces, the loss's f32 among them."""
        return len({torch.float32} | {d for d, s in zip(dtypes, skip)
                                       if not s})


def batch_rows(batch: dict, par: Par | None) -> dict:
    """This rank's rows of its replica's batch: the ``data``-coordinate
    slice of the leading dim (the whole batch without a data axis)."""
    if par is None or par.dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % par.dp:
            raise ValueError(f"batch of {n} rows does not split over the "
                             f"{par.dp} data ranks")
        w = n // par.dp
        out[k] = v.narrow(0, par.dp_index * w, w)
    return out


__all__ = ["LeafPlace", "Par", "batch_rows", "blocks_of", "experts_split",
           "places_tree", "scale_grad"]
