"""Process start to the window's start: build (first run in a checkout),
weights, engine or optimizer state, warm-up."""


def read(rec):
    return rec["setup_s"]
