"""Runtime kernel launches (`cudaLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernel`, `cuLaunchKernelEx`) in the profiled job over its
synthesizer device calls.  Graph launches are counted apart and not here."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["calls"]:
        return None
    return prof["trace"].launches / prof["calls"]
