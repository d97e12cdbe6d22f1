"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load: every result prints the card's limit
beside the shares computed against these."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
FLOPS = {"bf16": BF16_FLOPS, "f32": F32_FLOPS}
