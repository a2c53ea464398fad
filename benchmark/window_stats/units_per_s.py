"""units_per_s: the units (frames, objects) of every request completed
in the window over the window's whole length, to the end of its last
request."""


def value(window: dict) -> float:
    return window["units"] / window["window_s"]
