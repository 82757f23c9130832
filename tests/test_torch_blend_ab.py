"""`gsattack_torch.scripts.blend_ab`: its reading of ptxas's report and its
arguments (the timing itself needs the card)."""

import pytest

from gsattack_torch.scripts import blend_ab

# ptxas's report for the first blend kernels and one gather kernel, as
# `_cuda.build(verbose=True)` prints it (names shortened).
REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__0769ccc3_8_blend_cu_8f4688fa16blend_bwd_kernelILi19EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__0769ccc3_8_blend_cu_8f4688fa16blend_bwd_kernelILi19EEEvPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 28932 bytes smem
ptxas info    : Compile time = 92.949 ms
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__0769ccc3_8_blend_cu_8f4688fa16blend_fwd_kernelILi3EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__0769ccc3_8_blend_cu_8f4688fa16blend_fwd_kernelILi3EEEvPKfS2_
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 9216 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__ee0486ef_9_gather_cu_9619f01418gather_rows_kernelIfLi8EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__ee0486ef_9_gather_cu_9619f01418gather_rows_kernelIfLi8EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_reads_each_blend_kernel():
    assert blend_ab.ptxas_report(REPORT) == {
        # 80 registers: 2,560 a warp, 25 warps, 3 CTAs of 8 warps; shared
        # memory would allow 7.
        "bwd<19>": {"stack_bytes": 0, "spill_bytes": 0, "registers": 80, "smem_bytes": 28932,
                    "ctas_per_sm": 3},
        # 32 registers: 8 CTAs by registers and by threads; 23 by shared memory.
        "fwd<3>": {"stack_bytes": 8, "spill_bytes": 28, "registers": 32, "smem_bytes": 9216,
                   "ctas_per_sm": 8},
    }


def test_ptxas_report_limits_ctas_by_shared_memory():
    text = ("ptxas info    : Compiling entry function '_ZN..blend_fwd_kernelILi19EEEv' for 'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 40 registers, used 1 barriers, 46000 bytes smem\n")
    # 233,472 B a SM over 47,024 B a CTA: 4 (registers would allow 6).
    assert blend_ab.ptxas_report(text)["fwd<19>"]["ctas_per_sm"] == 4


def test_main_needs_a_root():
    with pytest.raises(SystemExit):
        blend_ab.main([])


def test_ptxas_report_reads_the_sum_kernels():
    # The redesigned sum (one template, two instantiations) and the
    # warp-a-gaussian kernel it replaced (a template on the group width),
    # names shortened.
    text = ("ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__b5d7c3dc_13_gather_sum_cu_"
            "4b20f83622gather_sum_rows_kernelILi2EEEvPKfPKiliiiPf' for 'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 32 registers, used 1 barriers, 19592 bytes smem\n"
            "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__b5d7c3dc_13_gather_sum_cu_"
            "4b20f83622gather_sum_rows_kernelILi4EEEvPKfPKiliiiPf' for 'sm_90a'\n"
            "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads\n"
            "ptxas info    : Used 40 registers, used 1 barriers, 20796 bytes smem\n"
            "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__b5d7c3dc_13_gather_sum_cu_"
            "4b20f83622gather_sum_rows_kernelILi32EEEvPKfPKiliiPf' for 'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 24 registers, used 0 barriers\n")
    assert blend_ab.ptxas_report(text) == {
        # 32 registers: 8 CTAs by registers and by threads; 11 by shared
        # memory (233,472 B over 20,616 B a CTA).
        "gather_sum_rows<2>": {"stack_bytes": 0, "spill_bytes": 0, "registers": 32,
                               "smem_bytes": 19592, "ctas_per_sm": 8},
        # 40 registers: 1,280 a warp, 51 warps, 6 CTAs.
        "gather_sum_rows<4>": {"stack_bytes": 8, "spill_bytes": 24, "registers": 40,
                               "smem_bytes": 20796, "ctas_per_sm": 6},
        "gather_sum_rows<32>": {"stack_bytes": 0, "spill_bytes": 0, "registers": 24,
                                "smem_bytes": 0, "ctas_per_sm": 8},
    }
