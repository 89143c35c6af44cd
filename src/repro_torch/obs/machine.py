"""Machine models: the hardware constants every bound in the port shares.

The port's copy of the JAX package's ``obs/machine.py``: one frozen
:class:`MachineModel` per target, with peak arithmetic throughput, memory and
link bandwidth, and ``word_ops_peak``, the 32-bit word operations a second
the mining kernels' cost model (:mod:`repro_torch.obs.profile`) prices
against.  ``word_ops_peak / hbm_bw`` is the machine balance: a kernel family
whose modeled ops per byte fall below it is bandwidth-bound.

The same constants are the yardstick of ``chip_smoke.py``'s ``bound_ms``.
The profiler and the kernel table use them differently: the profiler counts
three word operations a word (AND, population count, add) at the integer
rate, as the reference's model does; the kernel table counts each kernel's
real instructions at the rate of the pipe that issues them.
"""
from __future__ import annotations

import dataclasses

import torch

# H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): 3.35 TB/s of HBM3,
# 989 TFLOP/s in bf16 and 1,979 T/s in int8 on the tensor cores, NVLink at
# 450 GB/s each way to the host's other cards.  The data sheet gives no
# 32-bit integer rate.  The CUDA C++ Programming Guide's arithmetic-instruction
# throughput table gives, per clock and SM on compute capability 9.0, 64
# 32-bit integer adds or bitwise operations and 16 population counts; the SM
# count is read from the device, at the H100 SXM's 1.98 GHz maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT32_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
INT8_TENSOR_OPS_PER_S = 1.979e15
BF16_TENSOR_FLOPS_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9
H100_SXM_SMS = 132


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Roofline constants of one execution target."""

    name: str
    peak_flops: float       # bf16 FLOP/s (dense matrix-product peak)
    hbm_bw: float           # bytes/s main-memory bandwidth
    link_bw: float          # bytes/s per interconnect link
    word_ops_peak: float    # 32-bit word ops/s (mining-kernel peak)

    @property
    def balance_word_ops_per_byte(self) -> float:
        """Machine balance for the word-op kernels: ops/byte at the ridge."""
        return self.word_ops_peak / self.hbm_bw


def h100_sxm(sms: int = H100_SXM_SMS) -> MachineModel:
    """The H100 SXM with ``sms`` streaming multiprocessors."""
    return MachineModel(
        name="h100-sxm",
        peak_flops=BF16_TENSOR_FLOPS_PER_S,
        hbm_bw=HBM_BYTES_PER_S,
        link_bw=NVLINK_BYTES_PER_S,
        word_ops_peak=sms * SM_CLOCK_HZ * INT32_PER_CLOCK_SM,
    )


H100_SXM = h100_sxm()

#: A container-class x86 host, the reference's round numbers: the profiler's
#: verdicts compare terms against each other, so only their ratio (the
#: balance, 2.5 ops/byte) needs to be in the right regime.
CPU_HOST = MachineModel(
    name="cpu-host",
    peak_flops=2e11,
    hbm_bw=20e9,
    link_bw=10e9,
    word_ops_peak=5e10,
)


def machine_for_device(device: str | torch.device) -> MachineModel:
    """The model to price kernels against on ``device``: the H100 SXM with
    the card's own SM count for a CUDA device, the host for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return h100_sxm(torch.cuda.get_device_properties(index).multi_processor_count)
    return CPU_HOST
