"""Format layer: GFA / GTF / GAF / FASTA / VCF parsers and writers.

Pure-Python host code (no jax imports) so the CLI starts fast and the
parsers can run in data-loader worker processes.
"""
