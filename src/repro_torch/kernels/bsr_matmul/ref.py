"""Plain oracles of the block-sparse matmul kernel."""
import torch


def bsr_matmul_ref(h: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The dense-equivalent ground truth: zeros contribute zero."""
    return torch.matmul(h.float(), w.float()).to(out_dtype or h.dtype)


def bsr_matmul_schedule_ref(h, w, ids, cnt, block, out_dtype=None) -> torch.Tensor:
    """Executes the schedule (ids, cnt) literally, block by block: tells
    schedule bugs from kernel bugs. Equals `bsr_matmul_ref` when the
    schedule covers every live block."""
    bt, bf = block[0], block[1]
    t, f = h.shape
    d = w.shape[1]
    out = torch.zeros((t, d), dtype=torch.float32, device=h.device)
    for i in range(-(-t // bt)):
        rows = slice(i * bt, min((i + 1) * bt, t))
        acc = torch.zeros((rows.stop - rows.start, d), dtype=torch.float32,
                          device=h.device)
        for k in range(int(cnt[i])):
            fb = int(ids[i, k])
            cols = slice(fb * bf, min((fb + 1) * bf, f))
            acc += h[rows, cols].float() @ w[cols].float()
        out[rows] = acc
    return out.to(out_dtype or h.dtype)
