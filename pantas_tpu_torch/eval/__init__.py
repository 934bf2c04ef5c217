"""Evaluation helpers of the port: the synthetic inputs (:mod:`.synth`)."""
