"""Seconds from the process's start to the window's: loading, building, warming up."""


def read(rec):
    return rec.setup_s if rec.setup_s > 0 else None
