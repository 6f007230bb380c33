"""Host-to-device bytes the tier store billed in the window (its
``TrafficLog``, every entry whose destination is the device), in KiB per
output token."""


def read(rec):
    n = rec["window"]["tokens"]
    return rec["h2d_bytes"] / n / 1024 if n else None
