"""Frozen copy of the port's pangenome build code (``pantas_tpu_torch/build``):
FA + GTF + VCF -> annotated spliced pangenome, the graph every cell runs on."""
