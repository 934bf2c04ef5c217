"""Evaluation helpers of the port: the synthetic inputs (:mod:`.synth`), the
AS-event simulator with its truth (:mod:`.simulate`, :mod:`.sim_truth`), the
scorers (:mod:`.compare`, :mod:`.cmp_tools`, :mod:`.converters`), the mapper's
accuracy sweep (:mod:`.mapper_accuracy`) and the host tools around them
(:mod:`.gaf2sam`, :mod:`.support`, :mod:`.introns`, :mod:`.bench`,
:mod:`.exps_helpers`)."""
