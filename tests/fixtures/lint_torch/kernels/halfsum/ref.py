"""Fixture: half-precision running sums in a plain version.  accum-dtype
must flag the bf16 accumulator, the cumsum over bf16 values, and the sum
of rounded-then-widened scores, and let the contract's idioms pass: a bf16
matmul, a sum with dtype=torch.float32, and a final cast on the way out."""
import torch


def halfsum_ref(qw, docs, values, ids):
    acc = torch.zeros((qw.shape[0], docs), dtype=torch.bfloat16)
    acc.index_add_(1, ids, values)  # BAD: the accumulator is bf16
    w = qw.to(torch.bfloat16)
    run = w.cumsum(-1)  # BAD: a running sum in bf16
    rounded = (qw @ values.T).to(torch.bfloat16).float()
    total = rounded.sum(-1)  # BAD: sums values already rounded
    scores = torch.zeros(qw.shape[0])
    scores += rounded[:, 0]  # BAD: folds a rounded value into f32
    ok = w @ w.T  # the tensor cores accumulate in f32: allowed
    wide = w.sum(-1, dtype=torch.float32)  # allowed
    return (acc, run, total, scores, ok, wide.to(torch.bfloat16))
