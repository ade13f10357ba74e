"""(ids, cnt) schedule invariants, RPA207 (counterpart of
`repro.analysis.schedules`).

The schedules the port makes (`core.sparsity.compact_block_ids`,
`kernels.bsr_matmul.ops.block_schedule`, the ops' batched schedules) always
have:

  - 0 <= cnt <= n_blocks            (the kernel loops cnt times)
  - every id in [0, n_blocks)       (an out-of-range id gathers memory
                                     outside the operand)
  - ids[:cnt] strictly increasing   (the sort is stable, so live blocks keep
                                     their order; a repeated id is refused by
                                     `kernels.schedule_guard`, since the
                                     kernels and the reference would sum it a
                                     different number of times)

Entries beyond cnt are padding, constrained only by the range check.

These checks run on concrete values (tensors or arrays, moved to the host),
so they apply to the static BSR weight schedules and to test values. The
run-time counterpart on the ops' own schedules is
`kernels.schedule_guard.guard_schedule` (REPRO_CHECK_SCHEDULES=1), whose
repeated-block test this module shares.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.diagnostics import DiagnosticSink
from repro_torch.kernels.schedule_guard import repeated_blocks


def check_schedule(ids, cnt, n_blocks: int, sink: DiagnosticSink, *,
                   layer: int | None = None, kind: str = "",
                   impl: str = "") -> None:
    """Verify one schedule: ids (n,) with scalar cnt, or ids (rows, n) with
    cnt (rows,), the per-row-block (BSR) / per-sample (batched conv) forms.
    Appends RPA207 diagnostics for every violated invariant."""
    loc = dict(layer=layer, kind=kind, impl=impl)
    ids = torch.as_tensor(ids).cpu()
    cnt = torch.as_tensor(cnt).cpu()
    if ids.ndim == 1:
        ids, cnt = ids[None], cnt.reshape(1)
    if ids.ndim != 2 or tuple(cnt.shape) != (ids.shape[0],):
        sink.add("RPA207",
                 f"schedule shape mismatch: ids {tuple(ids.shape)} with cnt "
                 f"{tuple(cnt.shape)} (want (rows, n) ids with (rows,) cnt)",
                 **loc)
        return
    if n_blocks <= 0:
        sink.add("RPA207", f"schedule over n_blocks={n_blocks} (must be >= 1)",
                 **loc)
        return
    repeated = repeated_blocks(ids, cnt, n_blocks).tolist()
    for r in range(ids.shape[0]):
        row, c = ids[r], int(cnt[r])
        tag = f"row {r}: " if ids.shape[0] > 1 else ""
        if not 0 <= c <= n_blocks:
            sink.add("RPA207",
                     f"{tag}cnt={c} outside [0, n_blocks={n_blocks}]: the "
                     f"kernel would loop past the schedule",
                     hint="cnt counts live blocks; it can never exceed the "
                          "grid", **loc)
            continue
        if row.numel() and (int(row.min()) < 0 or int(row.max()) >= n_blocks):
            sink.add("RPA207",
                     f"{tag}ids outside [0, {n_blocks}): min={int(row.min())} "
                     f"max={int(row.max())}: an out-of-range id gathers "
                     f"outside the operand", **loc)
            continue
        if repeated[r]:
            sink.add("RPA207",
                     f"{tag}ids[:cnt] list a block more than once: the "
                     f"kernels sum it once, the reference once per listing",
                     **loc)
            continue
        live = row[:c]
        if live.numel() > 1 and not bool((live[1:] > live[:-1]).all()):
            sink.add("RPA207",
                     f"{tag}ids[:cnt] not strictly increasing: an unsorted "
                     f"schedule breaks the compaction order the kernels "
                     f"assume", **loc)


def schedule_ok(ids, cnt, n_blocks: int) -> bool:
    """Boolean convenience wrapper (tests / REPL)."""
    sink = DiagnosticSink()
    check_schedule(ids, cnt, n_blocks, sink)
    return not sink.items
