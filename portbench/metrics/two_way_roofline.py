"""two_way_roofline: K9's (`csrc/two_way.cu`: the image side of SAM's
two-way transformer, one pass per prompt and key row) least possible time
for the rows it served in the profiled window over its device time there,
in percent.  The rows are the program's counter `sam.key_rows_fused`
(B * N a call, `ops/two_way.two_way_keys`), which the port appends to
`timer.PROFILED` while torch.profiler runs; the harness reads that record
from the module the run has loaded.  Per row the least work is what the
row must write, 1024 bytes (keys_out 512, kp and vp 256 each, bf16), and
262,144 tensor-core operations (four 256 x 128 products), through
`bound_tc_s`: the reads, the float32 softmax and LayerNorm are left out,
so the bound lies below any time the kernel can take and the reading
cannot pass 100%.  None where the program counts no such rows (a program
without K9) or the profile holds no K9 time."""

import sys

from portbench.harness.peaks import bound_tc_s
from portbench.harness.spans import RECORDER

BYTES_PER_ROW = 1024
TC_OPS_PER_ROW = 262144


def read(rec):
    got = getattr(sys.modules.get(RECORDER), "PROFILED", None)
    if not rec.trace or rec.profile is None or got is None:
        return None
    rows = sum(n for name, n, _, _ in got.counts
               if name == "sam.key_rows_fused")
    if not rows:
        return None
    sec, _ = rec.profile.kernel_s(lambda name: "two_way_mma_kernel" in name
                                  or "two_way_f32_kernel" in name)
    if sec <= 0:
        return None
    return 100.0 * bound_tc_s(rows * BYTES_PER_ROW,
                              rows * TC_OPS_PER_ROW) / sec
