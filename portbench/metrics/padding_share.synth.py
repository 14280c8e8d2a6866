"""Frame-rows the synthesizer's device calls computed for no real frame,
over the window, in %: 100 x (1 - frames / frame_rows) of
`Synthesizer.stats`, differenced over the window (frame_rows: batch bucket
x frame bucket per device call, bucket retries included; frames: the real
rows' frames, counted as each batch's buffer reaches the host)."""


def read(run):
    c = run.get("counters", {})
    if not c.get("frame_rows") or "frames" not in c:
        return None
    return 100.0 * (1.0 - c["frames"] / c["frame_rows"])
