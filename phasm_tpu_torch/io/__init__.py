"""I/O of the port (FASTA, LAdump / PAF / .npz alignment tables, GFA2
graphs): host copies of the reference's ``phasm_tpu.io`` modules."""
