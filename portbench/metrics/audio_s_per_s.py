"""Seconds of audio delivered to the host as PCM16 over the window's wall
time (whole jobs, first start to last end).  Host clock."""


def read(run):
    if "audio_s" not in run or run.get("window_s", 0) <= 0:
        return None
    return run["audio_s"] / run["window_s"]
