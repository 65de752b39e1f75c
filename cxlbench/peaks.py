"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): what the rooflines and the step's share of the chip are
taken against.  The port's own fitted rates (MEMO) are not used here."""

#: bf16 and fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: fp32 FLOP/s outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES = 3.35e12
#: PCIe Gen5 x16 bytes/s in each direction (128 GB/s both ways together)
PCIE_BYTES_EACH_WAY = 64e9
