"""Data- and tensor-parallel training on a ("dp", "tp") mesh.

Counterpart of `sam6d_tpu/parallel/sharding.py`, whose pjit step is one
global program: the tp rules there only lay the Dense kernels out, and
XLA inserts the collectives.  Here they are written out, and this module
alone knows the layout: `shard_train_state` turns the layers it splits
into the tp subclasses below, so the model's own modules stay single-rank.

* **tp**: Megatron pairs on the port's `Dense` (`models/layers.py`).
  Column-parallel {qkv, fc1, expand, proj_q, proj_k, proj_v, proj_p}
  hold a slice of their outputs (weight rows, bias); row-parallel {fc2,
  squeeze, proj, linear} a slice of their inputs (weight columns), their
  partial products summed over `tp` before the whole bias is added.  A
  torch weight is (out, in), so the JAX kernel's P(None, "tp") is a split
  of dim 0 here.  `qkv`'s rows are regrouped so that a rank holds whole
  heads of q, k and v; every attention then runs its own heads
  (`num_heads / tp`).  The linear attention's `scale`, per channel of
  q and k, is split with them (the JAX rule replicates it; each rank
  uses only its channels either way), and its channel norms sum over
  the group.  Every other leaf is replicated.
* **dp**: each rank takes its B / dp rows of the global batch and its
  rows of the one global draw of the pose noise; BatchNorm sums its
  moments over `dp`; the gradients are averaged over `dp` before the
  global-norm clip and the spike test, so every rank clips and skips
  alike.  A dp step equals the one-process step on the whole batch.

The global gradient norm counts each sharded leaf's slices once (summed
over `tp`) and each replicated leaf once.  `unsharded_state_dict` gathers
the full weights, which `train/checkpoint.save_params` writes on rank 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sam6d_tpu_torch.models.layers import BatchNorm, Dense
from sam6d_tpu_torch.models.pem.matching import draw_pose_noise
from sam6d_tpu_torch.models.pem.transformer import (
    LinearAttention,
    MultiHeadAttention,
    RPEMultiHeadAttention,
)
from sam6d_tpu_torch.models.vit import Attention as ViTAttention
from sam6d_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_in,
    reduce_out,
)
from sam6d_tpu_torch.parallel.mesh import (
    DP,
    TP,
    axis_group,
    axis_index,
    axis_size,
    has_axis,
)

COL_PARALLEL = {"qkv", "fc1", "expand", "proj_q", "proj_k", "proj_v",
                "proj_p"}
ROW_PARALLEL = {"fc2", "squeeze", "proj", "linear"}


def param_partition_spec(name: str, param) -> tuple:
    """The layout of one state-dict entry, keyed on its module's name: a
    tuple with "tp" at the split dim (the JAX rule's P on the transposed
    kernel), () for a replicated entry."""
    *_, parent, leaf = ("", *name.split("."))
    ndim = getattr(param, "ndim", 0)
    if parent in COL_PARALLEL and leaf in ("weight", "bias"):
        return ("tp",) + (None,) * (ndim - 1)
    if parent in ROW_PARALLEL and leaf == "weight" and ndim == 2:
        return (None, "tp")
    if parent == "attention" and leaf == "scale" and ndim == 3:
        return (None, None, "tp")  # LinearAttention's, with proj_q / proj_k
    return ()


def _rows(name: str, n_rows: int, tp: int, rank: int) -> torch.Tensor:
    """The rows of a column-parallel entry that rank holds: a contiguous
    slice, except qkv's, which takes its slice of each of q, k and v."""
    parts = 3 if name.split(".")[-2] == "qkv" else 1
    per = n_rows // parts // tp
    return torch.cat([torch.arange(p * n_rows // parts + rank * per,
                                   p * n_rows // parts + (rank + 1) * per)
                      for p in range(parts)])


class _ColDense(Dense):
    """Column-parallel: this rank's outputs; the replicated input enters
    through `copy_in`."""

    def forward(self, x):
        return super().forward(copy_in(x, self.tp_group))


class _RowDense(Dense):
    """Row-parallel: this rank's inputs; the partial products summed over
    tp (`reduce_out`), then the whole bias added once."""

    def forward(self, x):
        y = reduce_out(F.linear(x.to(self.dtype), self.weight.to(self.dtype)),
                       self.tp_group)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class _TPRPEAttention(RPEMultiHeadAttention):
    """This rank's heads; the replicated embedding reaches them through
    proj_p's kernel, so it enters through `copy_in`."""

    def forward(self, q_in, k_in, v_in, embed_qk):
        return super().forward(q_in, k_in, v_in,
                               copy_in(embed_qk, self.tp_group))


class _TPLinearAttention(LinearAttention):
    """This rank's heads and channels (of `scale` too); a norm over the
    channels sums its squares over tp."""

    def _norm(self, x):
        return torch.sqrt(all_reduce_sum((x * x).sum(-1, keepdim=True),
                                         self.tp_group))


class _SyncBatchNorm(BatchNorm):
    """Train-mode moments of the whole batch: each rank's sums (it holds a
    slice of the batch) added over dp."""

    def _moments(self, xf, axes):
        C = xf.shape[-1]
        sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                          xf.new_full((1,), float(xf.numel() // C))])
        sums = all_reduce_sum(sums, self.dp_group)
        return sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]


def _relayout(module, cls, **groups):
    """Make `module` a `cls` (a subclass of its class) in place."""
    module.__class__ = cls
    module.__dict__.update(groups)


def _sharded_params(model):
    """(state-dict name, parameter, split dim, tp group) of every
    tp-sharded entry."""
    for mname, m in model.named_modules():
        if not isinstance(m, (_ColDense, _RowDense, _TPLinearAttention)):
            continue
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}"
            spec = param_partition_spec(name, p)
            if spec:
                yield name, p, spec.index("tp"), m.tp_group


class ParallelTraining:
    """One rank's place on a ("dp", "tp") mesh and the collectives of a
    step.  Built by `shard_train_state`, kept as `TrainState.parallel`."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = axis_size(mesh, DP)
        self.tp = axis_size(mesh, TP)
        self.dp_index = axis_index(mesh, DP)
        self.tp_index = axis_index(mesh, TP)
        self.dp_group = axis_group(mesh, DP) if has_axis(mesh, DP) else None
        self.tp_group = axis_group(mesh, TP) if has_axis(mesh, TP) else None
        self.sharded: set[int] = set()  # ids of tp-sharded parameters

    def local_rows(self, n: int) -> slice:
        if n % self.dp:
            raise ValueError(f"batch {n} does not split over dp {self.dp}")
        per = n // self.dp
        return slice(self.dp_index * per, (self.dp_index + 1) * per)

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors)."""
        if self.dp == 1:
            return batch
        rows = self.local_rows(len(next(iter(batch.values()))))
        return {k: v[rows] for k, v in batch.items()}

    def pose_noise(self, global_batch: int, generator, device, noise=None):
        """This rank's rows of the global batch's pose noise: of `noise`
        (std_rot, n_rot, n_trans) if given, else of one draw from
        `generator` (the same on every rank)."""
        if noise is None:
            noise = draw_pose_noise(global_batch, generator, device)
        std_rot, n_rot, n_trans = noise
        rows = self.local_rows(global_batch)
        return std_rot, n_rot[rows], n_trans[rows]

    def mean_over_dp(self, t: torch.Tensor) -> torch.Tensor:
        if self.dp > 1:
            dist.all_reduce(t, group=self.dp_group)
            t.div_(self.dp)
        return t

    def reduce_grads(self, grads: list) -> list:
        """Average every gradient over dp (in place)."""
        if self.dp > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.mean_over_dp(flat)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        return grads

    def grad_norm(self, params: list, grads: list) -> torch.Tensor:
        """The global norm: sharded leaves summed over tp, replicated
        leaves once."""
        from sam6d_tpu_torch.train.state import global_norm

        if self.tp == 1:
            return global_norm(grads)
        sq = [torch.zeros((), device=grads[0].device) for _ in range(2)]
        for p, g in zip(params, grads):
            sq[id(p) in self.sharded] += g.float().pow(2).sum()
        dist.all_reduce(sq[1], group=self.tp_group)
        return torch.sqrt(sq[0] + sq[1])



def _shard_(param: torch.nn.Parameter, name: str, dim: int, tp: int,
            rank: int) -> torch.Tensor:
    """Keep this rank's slice of `param` (in place: its `.data`); returns
    the index that took it, for the optimizer's state."""
    n = param.shape[dim]
    if n % tp:
        raise ValueError(f"{name}: {n} does not split over tp {tp}")
    idx = (_rows(name, n, tp, rank) if dim == 0
           else torch.arange(rank * n // tp, (rank + 1) * n // tp))
    param.data = param.data.index_select(dim, idx.to(param.device))
    return idx


def shard_train_state(state, mesh):
    """Lay a `TrainState` out on a ("dp", "tp") `mesh`, in place: each
    rank keeps its tp slice of the parameters and of the Adam moments
    (and of any accumulated gradients), the split layers and BatchNorm
    become their tp and dp subclasses above, and `state.parallel` holds
    the step's collectives.  Returns `state`."""
    plan = ParallelTraining(mesh)
    model, opt = state.model, state.optimizer
    if plan.tp > 1:
        tp = dict(tp_group=plan.tp_group)
        for mname, m in model.named_modules():
            leaf = mname.rsplit(".", 1)[-1]
            if isinstance(m, (ViTAttention, MultiHeadAttention,
                              LinearAttention)):
                if m.num_heads % plan.tp:
                    raise ValueError(f"{m.num_heads} heads do not split "
                                     f"over tp {plan.tp}")
                m.num_heads //= plan.tp
                if isinstance(m, RPEMultiHeadAttention):
                    _relayout(m, _TPRPEAttention, **tp)
                elif isinstance(m, LinearAttention):
                    _relayout(m, _TPLinearAttention, **tp)
            elif isinstance(m, Dense) and leaf in COL_PARALLEL:
                _relayout(m, _ColDense, **tp)
            elif isinstance(m, Dense) and leaf in ROW_PARALLEL:
                _relayout(m, _RowDense, **tp)
        acc = dict(zip(map(id, opt.params), opt.acc or []))
        for name, p, dim, _ in list(_sharded_params(model)):
            idx = _shard_(p, name, dim, plan.tp, plan.tp_index)
            plan.sharded.add(id(p))
            moments = opt.adam.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in moments:
                    moments[key] = moments[key].index_select(
                        dim, idx.to(p.device))
            if id(p) in acc:
                a = acc[id(p)]
                a.data = a.data.index_select(dim, idx.to(p.device))
    if plan.dp > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                _relayout(m, _SyncBatchNorm, dp_group=plan.dp_group)
    state.parallel = plan
    return state


def unsharded_state_dict(model) -> dict:
    """The model's state dict with every tp-sharded entry gathered back to
    its full shape (qkv's rows in their q, k, v order).  A collective:
    every rank of the tp group calls it."""
    out = dict(model.state_dict())
    for name, p, dim, group in _sharded_params(model):
        tp = dist.get_world_size(group)
        parts = [torch.empty_like(p.data) for _ in range(tp)]
        dist.all_gather(parts, p.data.contiguous(), group=group)
        full = torch.cat(parts, dim=dim)
        if dim == 0:
            order = torch.cat([_rows(name, full.shape[0], tp, r)
                               for r in range(tp)])
            full = torch.empty_like(full).index_copy_(
                0, order.to(full.device), full)
        out[name] = full
    return out
