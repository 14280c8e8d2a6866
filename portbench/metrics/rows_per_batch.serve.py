"""Requests per batch of the server's batcher over the window:
`batched_requests / batches` of `GET /stats`, differenced over the window."""


def read(run):
    if not run.get("batches"):
        return None
    return run["batched_requests"] / run["batches"]
