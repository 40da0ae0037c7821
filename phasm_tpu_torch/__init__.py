"""phasm_tpu_torch — the PyTorch + CUDA port of phasm_tpu for NVIDIA Hopper.

The JAX package ``phasm_tpu`` stays the reference.  This package owns only
the device work of the main path (simulate -> overlap -> assemble -> eval)
and imports the reference's host-only modules (seeding, filters, graph
cleaning, bubbles, native polish, I/O, eval) and config dataclasses as they
are.  It imports ``torch`` and never ``jax``.

Layer map (counterpart of each reference module in brackets):

  device        resolve_device: explicit torch.device, never a silent CPU
  state         DeviceReads: the read set resident on the device
  _build        nvcc -> ctypes loader for csrc/*.cu (sm_90a)
  overlap/      myers (plain Myers core) + myers_cuda (kernels 1, 2),
                extend (plain dp_core, W-band kernel 3, DeviceExtender),
                engine (overlap_reads)                  [phasm_tpu.overlap]
  graph/        transitive reduction                    [phasm_tpu.graph]
  phasing       batched branch scorer + lockstep loop   [phasm_tpu.phasing]
  pipeline      assemble + round-2 polish placement     [phasm_tpu.pipeline]
  configs       run_rung over the reference ladder      [phasm_tpu.configs]
  cli           simulate / pipeline subcommands         [phasm_tpu.cli]

Every CUDA kernel has a plain PyTorch version beside it; a wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for CUDA
tensors.
"""

__version__ = "0.1.0"
