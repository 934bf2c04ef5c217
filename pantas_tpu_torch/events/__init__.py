"""The call stage's device engine of the port (:mod:`.batched`): the six
bitset finders as torch ops, and :func:`call_events_device`. The host caller
is ``pantas_tpu.events.caller``, used as it is."""

from pantas_tpu_torch.events.batched import call_events_device  # noqa: F401
