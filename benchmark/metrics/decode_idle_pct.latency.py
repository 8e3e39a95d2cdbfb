"""The share of the slice's device-idle time that falls inside the
program's ``rtvc.decode.token`` ranges (idle as ``device_idle_pct``
takes it, the complement of the union of the device's activity): the
idle time a decode the host does not issue token by token could
remove."""

from benchlib.spans import idle_share_pct


def read(run):
    return idle_share_pct(run, "rtvc.decode.token")
