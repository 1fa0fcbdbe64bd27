"""Seconds of ``pack.upload`` spans, the pack builders' host-to-device
copies (with the stream wait a pageable copy makes first), per
``partition()`` call."""


def read(run):
    if run.loop != "partition":
        return None
    return run.span_seconds("pack.upload")
