"""Overlap on the port's device path: the plain Myers core (myers), kernels
1 and 2 (myers_cuda), the W-band dp_core twin with kernel 3 and the device
extender (extend), and the engine (engine.overlap_reads)."""
