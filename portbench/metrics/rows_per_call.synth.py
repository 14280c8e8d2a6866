"""Utterances over the synthesizer's device calls in the window
(`Synthesizer.stats["calls"]`, bucket retries included)."""


def read(run):
    if not run.get("calls") or "utterances" not in run:
        return None
    return run["utterances"] / run["calls"]
