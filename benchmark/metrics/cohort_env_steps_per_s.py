"""Env-steps whose results reached the host, over the whole window: every
completed call's work divided by the seconds from the first call's start
to the last one's end."""


def read(rec):
    return rec["work"] / rec["window_s"]
