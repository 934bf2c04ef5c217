"""Seconds a job spends in the novel pass's host enumerator, the program's
span ``call.novel_walk``: its loop over the novel junctions
(``call.novel_walk.novel_junctions``: the exonic splice-site rows of the
card's hits, the intronic walk, novel IR) and its loop over the annotated
ones (``call.novel_walk.annotated_junctions``: cassette-exon rows, IR-2)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.novel_walk")
