"""Frozen copies of the port's FASTA, GTF and VCF readers (``pantas_tpu_torch/io``)."""
