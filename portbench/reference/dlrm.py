"""Device mode's DLRM in plain PyTorch, for the check that decides
``correct``.

It imports nothing of the program (``persia_tpu_torch``), of jax or of
the JAX package. From the benchmark's initial weights
(:mod:`portbench.weights`) and batches (:mod:`portbench.generator`) it
works out again what the program derives: the row each raw id hashes to,
the pooled embeddings, the tower's predictions, the loss, the gradients
and the Adagrad steps.

``precision`` is the products' precision:

- ``"bfloat16"``, what the configurations state: float32 parameters,
  tables and sums; every product's operands rounded to bfloat16
  (float32 accumulation), the pooled embeddings rounded to bfloat16 once;
- ``"float8"``, the control one step below: every product's operands and
  the pooled embeddings rounded to float8 e4m3 under a per-tensor scale
  (its largest magnitude to 448), the products in float32 with TF32 off;
  the gradient passes the rounding unchanged (straight through), so
  the backward's products take the rounded operands too.
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F

from portbench.arch import Arch


def hash_rows(ids: torch.Tensor, vocab: int):
    """Device mode's hash of raw ids into a table's rows (a frozen copy of
    ``DeviceEmbeddingCollection``'s rule): ids <= 0 are padding, ``mask =
    ids > 0`` and ``rows = ((ids % (vocab - 1)) + 1) * mask`` (int64), so
    padding reads row 0 with weight 0."""
    mask = ids > 0
    return ((ids.long() % (vocab - 1)) + 1) * mask, mask


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


def caster(precision: str):
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16)
    if precision == "float8":
        return _Float8.apply
    raise ValueError(f"unknown precision {precision!r}")


def bce(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of sigmoid outputs clipped at 1e-7."""
    pred = pred.clamp(1e-7, 1.0 - 1e-7)
    return -torch.mean(label * torch.log(pred)
                       + (1.0 - label) * torch.log(1.0 - pred))


class Dlrm:
    """The tower over ``tensors`` in :func:`portbench.arch.leaves` order
    (tables, then each layer's weight and bias)."""

    def __init__(self, a: Arch, tensors: Sequence[torch.Tensor],
                 precision: str):
        self.a = a
        self.cast = caster(precision)
        self.tables = list(tensors[:a.fields])
        self.dense = list(tensors[a.fields:])
        nb = len(a.bottom_layers())
        pairs = list(zip(self.dense[0::2], self.dense[1::2]))
        self.bottom, self.top = pairs[:nb], pairs[nb:]
        f = a.fields + 1
        self.iu, self.ju = torch.triu_indices(f, f, offset=1,
                                              device=tensors[0].device)

    def _mlp(self, x, layers, last_relu: bool):
        c = self.cast
        for i, (w, b) in enumerate(layers):
            x = F.linear(c(x), c(w), c(b))
            if i < len(layers) - 1 or last_relu:
                x = torch.relu(x)
        return x

    def rows(self, ids: torch.Tensor):
        """Per field, the (B, S) rows and mask of (fields, B, S) ids."""
        return [hash_rows(ids[k], vocab) for k, vocab in
                enumerate(self.a.rows)]

    def pooled(self, gathered, rows) -> List[torch.Tensor]:
        """Sum pooling of each field's gathered (B, S, D) rows, float32."""
        return [(g * m.unsqueeze(-1)).sum(dim=1)
                for g, (_, m) in zip(gathered, rows)]

    def predict(self, dense: torch.Tensor, pooled) -> torch.Tensor:
        """(B,) float32 predictions of the pooled (B, D) fields."""
        bottom = self._mlp(dense, self.bottom, True)
        t = self.cast(torch.cat([bottom[:, None].float(),
                                 torch.stack(pooled, dim=1)], dim=1))
        z = torch.bmm(t, t.transpose(1, 2))
        top_in = torch.cat([t[:, 0], z[:, self.iu, self.ju]], dim=1)
        return torch.sigmoid(self._mlp(top_in, self.top, False).float()
                             ).squeeze(1)


def _device_batch(pool, j: int, device):
    return (pool.dense[j].to(device), pool.ids[j].to(device),
            pool.labels[j].to(device).reshape(-1))


@torch.no_grad()
def predict(a: Arch, tensors, pool, precision: str, block: int = 16384
            ) -> List[torch.Tensor]:
    """Each pool batch's (B,) predictions on the host, in blocks of
    ``block`` samples."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Dlrm(a, tensors, precision)
    device = tensors[0].device
    out = []
    for j in range(len(pool)):
        dense, ids, _ = _device_batch(pool, j, device)
        parts = []
        for lo in range(0, dense.shape[0], block):
            blk_ids = ids[:, lo:lo + block]
            rows = model.rows(blk_ids)
            gathered = [model.tables[k][r] for k, (r, _) in enumerate(rows)]
            parts.append(model.predict(dense[lo:lo + block],
                                       model.pooled(gathered, rows)))
        out.append(torch.cat(parts).cpu())
    return out


def train(a: Arch, tensors: List[torch.Tensor], pool, precision: str,
          steps: int = 3):
    """``steps`` training steps from the weights in ``tensors`` (updated
    in place) on pool batches 0.. ``steps - 1``. Returns (each step's
    loss, each leaf's gradient norm at the first step, each leaf's
    change norm after the first step and after the last)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Dlrm(a, tensors, precision)
    device = tensors[0].device
    batches = [_device_batch(pool, j, device) for j in range(steps)]
    rows = [model.rows(ids) for _, ids, _ in batches]
    touched = [torch.unique(torch.cat([r[k][0].reshape(-1) for r in rows]))
               for k in range(a.fields)]
    start_rows = [t[u].clone() for t, u in zip(model.tables, touched)]
    start_dense = [t.clone() for t in model.dense]
    acc_rows = [torch.full((u.numel(), a.dim), a.initial_accumulator,
                           device=device) for u in touched]
    acc_dense = [torch.full_like(t, a.initial_accumulator)
                 for t in model.dense]
    losses, grad_norms = [], None

    def changes():
        return ([torch.linalg.vector_norm(t[u] - s0).item() for t, u, s0
                 in zip(model.tables, touched, start_rows)]
                + [torch.linalg.vector_norm(t - s0).item()
                   for t, s0 in zip(model.dense, start_dense)])

    for t in model.dense:
        t.requires_grad_(True)
    for (dense, _, label), step_rows in zip(batches, rows):
        gathered = [t[r].requires_grad_() for t, (r, _) in
                    zip(model.tables, step_rows)]
        with torch.enable_grad():
            loss = bce(model.predict(dense, model.pooled(gathered,
                                                         step_rows)),
                       label)
            grads = torch.autograd.grad(loss, gathered + model.dense)
        losses.append(loss.item())
        with torch.no_grad():
            row_grads = []
            for k, ((r, _), g) in enumerate(zip(step_rows, grads)):
                at = torch.searchsorted(touched[k], r.reshape(-1))
                row_grads.append(torch.zeros_like(acc_rows[k]).index_add_(
                    0, at, g.reshape(-1, a.dim)))
            dense_grads = grads[a.fields:]
            if grad_norms is None:
                grad_norms = [torch.linalg.vector_norm(g).item()
                              for g in row_grads + list(dense_grads)]
            for k, g in enumerate(row_grads):
                acc_rows[k].addcmul_(g, g)
                model.tables[k][touched[k]] = model.tables[k][touched[k]].add(
                    g * torch.rsqrt(acc_rows[k] + a.eps), alpha=-a.lr)
            for t, s, g in zip(model.dense, acc_dense, dense_grads):
                s.addcmul_(g, g)
                t.add_(g * torch.rsqrt(s + a.eps), alpha=-a.lr)
            if len(losses) == 1:
                first = changes()
    with torch.no_grad():
        return losses, grad_norms, first, changes()
