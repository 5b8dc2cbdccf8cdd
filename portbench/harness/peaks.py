"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

H100_BF16_FLOPS = 989e12   # tensor-core bf16
H100_INT8_OPS = 1979e12    # tensor-core int8
H100_F32_FLOPS = 67e12     # f32 on CUDA cores
HBM_BYTES = 3.35e12        # HBM3 bytes/s

PEAK_OPS = {"bf16": H100_BF16_FLOPS, "int8": H100_INT8_OPS,
            "f32": H100_F32_FLOPS}
