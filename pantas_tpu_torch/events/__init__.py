"""The call stage of the port: the reference-exact host caller
(:mod:`.caller`), the novel-site detector (:mod:`.sites`) and the device
engine (:mod:`.batched`: the six bitset finders as torch ops, and
:func:`call_events_device`)."""

from pantas_tpu_torch.events.batched import call_events_device  # noqa: F401
from pantas_tpu_torch.events.caller import CallOptions, SplicingGraph, call_events  # noqa: F401
