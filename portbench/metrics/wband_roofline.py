"""wband_roofline: the W-band family's bound over one pass's W-band-routed
calls / the device time of every kernel those calls launched (the traced
pass with a sync around each call, spans ``portbench.call.wband``)."""
from portbench.metrics_common import family_roofline


def read(rec):
    return family_roofline(rec, "wband")
