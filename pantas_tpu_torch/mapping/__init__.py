"""Graph read mapping: FASTQ -> GAF against the spliced pangenome.

The reference delegates alignment to the external ``vg mpmap``
(``README.md:86-101``); this module provides a native path-guided
seed-and-extend mapper so the framework is self-contained end-to-end.
"""
