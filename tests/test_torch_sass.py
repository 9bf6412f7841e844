"""The SASS instruction counter behind the kernels' operation bound
(``ctgan_tpu_torch/kernels/sass.py``), on hand-written ``cuobjdump -sass``
text in the tool's format: the main loop's hot path, the kinds, the
elements per step and the bound.  On the card it runs on the build's own
SASS (chip_smoke.py)."""

from __future__ import annotations

import pytest

from ctgan_tpu_torch.kernels import sass

# A kernel in the first design's shape: the loop holds a vector store and,
# behind a branch, a ragged tail with its own loop of element stores.
FIRST = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119dropout_mask_kernelILi2EEEvPvljjf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0020*/               @P0 EXIT ;                                    /* 0x000000000000094d */
        /*0030*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;   /* 0x0000000000007919 */
        /*0040*/                   LOP3.LUT R4, R3, UR4, R5, 0x96, !PT ;     /* 0x0000000000007919 */
        /*0050*/                   UIADD3 UR4, UR4, 0x1, URZ ;               /* 0x0000000000007919 */
        /*0060*/                   ISETP.GE.U32.AND P1, PT, R4, UR5, PT ;    /* 0x0000000000007919 */
        /*0070*/                   SEL R6, RZ, UR6, P1 ;                     /* 0x0000000000007919 */
        /*0080*/                   BSSY B0, 0x130 ;                          /* 0x0000000000007919 */
        /*0090*/              @!P2 BRA 0xf0 ;                                /* 0x0000000000007919 */
        /*00a0*/                   ISETP.GE.AND P3, PT, R7, R8, PT ;         /* 0x0000000000007919 */
        /*00b0*/                   STG.E.U16 desc[UR8][R10.64], R6 ;         /* 0x0000000000007919 */
        /*00c0*/                   IADD3 R7, R7, 0x1, RZ ;                   /* 0x0000000000007919 */
        /*00d0*/               @P3 BRA 0xa0 ;                                /* 0x0000000000007919 */
        /*00e0*/                   BRA 0x120 ;                               /* 0x0000000000007919 */
        /*00f0*/                   LEA R10, P4, R0, UR10, 0x3 ;              /* 0x0000000000007919 */
        /*0100*/                   LEA.HI.X R11, R0, UR11, RZ, 0x3, P4 ;     /* 0x0000000000007919 */
        /*0110*/                   STG.E.64 desc[UR8][R10.64], R6 ;          /* 0x0000000000007919 */
        /*0120*/                   BSYNC B0 ;                                /* 0x0000000000007919 */
        /*0130*/                   IADD3 R0, R0, UR12, RZ ;                  /* 0x0000000000007919 */
        /*0140*/                   I2FP.F32.U32 R9, R0 ;                     /* 0x0000000000007919 */
        /*0150*/                   FMUL R9, R9, 0.5 ;                        /* 0x0000000000007919 */
        /*0160*/               @!P5 BRA 0x30 ;                               /* 0x0000000000007919 */
        /*0170*/                   EXIT ;                                    /* 0x000000000000794d */
        /*0180*/                   BRA 0x180;                                /* 0x0000000000007919 */
		..........
"""


def test_parse_reads_functions_guards_and_targets():
    (name, body), = sass.parse(FIRST).items()
    assert name.endswith("ILi2EEEvPvljjf") and len(body) == 25
    assert (body[2].pred, body[2].op) == ("@P0", "EXIT")
    branch = body[9]
    assert (branch.pred, branch.op, branch.target, branch.is_conditional) == ("@!P2", "BRA", 0xF0, True)
    assert not body[14].is_conditional and body[14].target == 0x120
    assert body[-1].target == 0x180  # the closing self-loop, which is no loop of the kernel


def test_loop_path_takes_the_vector_store_and_skips_the_tail():
    (body,) = sass.parse(FIRST).values()
    path = sass.loop_path(body)
    assert [ins.addr for ins in path] == [0x30, 0x40, 0x50, 0x60, 0x70, 0x80, 0x90, 0xF0, 0x100, 0x110,
                                          0x120, 0x130, 0x140, 0x150, 0x160]
    assert sum(ins.store_bytes for ins in path) == 8


@pytest.mark.parametrize("op,kind", [
    ("IMAD.WIDE.U32", "int"), ("LOP3.LUT", "int"), ("ISETP.GE.U32.AND", "int"), ("SEL", "int"),
    ("PRMT", "int"), ("FMUL", "fp32"), ("I2FP.F32.U32", "cvt"), ("F2F.BF16.F32", "cvt"), ("STG.E.128", "mem"),
    ("LDC.64", "mem"), ("BRA", "ctrl"), ("BSSY", "ctrl"), ("UIADD3", "uniform"), ("ULDC.64", "uniform"),
])
def test_classify(op, kind):
    assert sass.classify(op) == kind


def _kernels(text: str) -> str:
    """FIRST's body under the names of the three kernels."""
    body = text.split("\t.headerflags", 1)[1]
    names = ["dropout_mask_kernelIjEEvPT_lPKjijf", "dropout_mask_kernelItEEvPT_lPKjijf",
             "philox_uniform_kernelEPflPKjif"]
    return "".join(f"\t\tFunction : _ZN12_GLOBAL__N_1{n}\n\t.headerflags{body}" for n in names)


def test_kernel_counts_and_op_bound():
    counts = sass.kernel_counts(_kernels(FIRST))
    assert set(counts) == {"dropout_mask float32", "dropout_mask bfloat16", "philox_uniform"}
    bf16 = counts["dropout_mask bfloat16"]
    assert bf16["elements"] == 4 and bf16["philox_blocks"] == 1
    assert bf16["kinds"] == {"int": 7, "uniform": 1, "ctrl": 4, "mem": 1, "cvt": 1, "fp32": 1}
    assert counts["dropout_mask float32"]["elements"] == 2  # 8 bytes stored, 4-byte elements
    # 1e6 elements of 4 per step: 2.5e5 steps of 7 integer instructions at 64 per clock per SM
    ms, kind = sass.op_bound_ms(bf16, 1_000_000, sms=132, clock_hz=1.98e9)
    assert kind == "int"
    assert ms == pytest.approx(2.5e5 * 7 / 64 / (132 * 1.98e9) * 1e3)
    cvt_heavy = dict(bf16, kinds={"int": 1, "cvt": 1})
    assert sass.op_bound_ms(cvt_heavy, 4, sms=1, clock_hz=1.0) == (pytest.approx(1e3 / 16), "cvt")


def test_kernel_counts_needs_each_kernel_once():
    with pytest.raises(ValueError, match="found"):
        sass.kernel_counts(FIRST)
