"""myers_roofline: the Myers family's bound over one pass's Myers-routed
calls / the device time of every kernel those calls launched (the traced
pass with a sync around each call, spans ``portbench.call.myers``)."""
from portbench.metrics_common import family_roofline


def read(rec):
    return family_roofline(rec, "myers")
