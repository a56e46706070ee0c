"""Frames of every round finished in the window over the window's wall seconds."""


def read(rec):
    return rec.frames / rec.window_s if rec.rounds and rec.window_s > 0 else None
