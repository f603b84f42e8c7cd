"""Seconds of audio convolved per second of the window: streams x blocks
x fragm / rate over every step completed, over the window's wall
seconds (the host clock, from the first step issued to the window's
closing synchronize)."""


def read(run, trace):
    return run["audio_s"] / run["window_s"]
