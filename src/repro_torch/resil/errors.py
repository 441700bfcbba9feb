"""Request retirement outcomes, as in the reference's ``resil/errors.py``.

Every request retires with exactly one outcome from :data:`OUTCOMES`,
surfaced through the ``resil_requests_total{outcome=}`` metric family and
the trace ``request``-span end args.
"""

#: normal completion, load-shed (admission rejection), wall-clock deadline
#: cancellation, and retries-exhausted / unservable failure
OUTCOMES = ("ok", "shed", "timed_out", "failed")
