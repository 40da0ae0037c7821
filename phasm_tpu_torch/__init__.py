"""phasm_tpu_torch — the PyTorch + CUDA port of phasm_tpu for NVIDIA Hopper.

The JAX package ``phasm_tpu`` stays the reference.  This package is
self-contained: it imports ``torch`` and never ``jax``, and nothing of
``phasm_tpu``.  Its host modules are copies of the reference's, module for
module (numpy and ctypes, the same code with its imports pointed here), so
the two packages give the same answers on the same input; its device work
is its own.

Layer map (counterpart of each reference module in brackets):

  device        resolve_device: explicit torch.device, never a silent CPU;
                on_device: the current-card guard for work on another card
  state         DeviceReads: the read set resident on the device (``to``
                replicates it onto another); readset_from_arrays /
                alignment_table_from_matrix
  _build        nvcc -> ctypes loader for csrc/*.cu (sm_90a)
  native        g++ -> ctypes loader for csrc/phasm_native.cpp  [phasm_tpu.native]
  dna, reads, alignments, metrics, sim, filter, bubbles,
  bubbles_linear, eval, io/fasta, io/daligner, io/gfa
                                                      host copies [same names]
                (metrics.device_trace records with torch.profiler)
  overlap/      seeding (host copy), myers (plain Myers core) + myers_cuda
                (kernels 1, 2), extend (plain dp_core, W-band kernels 3
                and 4, batch entry point), routing, engine (overlap_reads,
                DeviceExtender; mesh= runs batches data-parallel)
                                                        [phasm_tpu.overlap]
  parallel/     mesh (Mesh, make_mesh, the shard merge), distributed
                (initialize: torch.distributed), sharded_overlap
                (sharded_extend_step)                   [phasm_tpu.parallel]
  graph/        host copies + transitive reduction pass [phasm_tpu.graph]
  phasing       batched branch scorer + lockstep loop   [phasm_tpu.phasing]
  pipeline      assemble + round-2 polish placement     [phasm_tpu.pipeline]
  configs       the ladder + run_rung                   [phasm_tpu.configs]
  cli           simulate, overlap, filter, layout, phase,
                pipeline subcommands                    [phasm_tpu.cli]
  ladder        the ladder runner, one JSON row a rung
                                         [scripts/run_ladder.py]
  bench         the headline bench (production alignments/s)
                                               [bench.py at the repo root]
  graft_entry   entry, dryrun_multichip   [__graft_entry__ at the repo root]

Every CUDA kernel has a plain PyTorch version beside it; a wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for CUDA
tensors.
"""

__version__ = "0.1.0"
