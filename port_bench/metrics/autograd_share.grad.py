"""The autograd engine's share of a gradient step (percent): host seconds
of the ``crt.autograd`` spans (each sample's ``torch.autograd.backward``)
over those of ``crt.grad_step``, in the second profiled slice."""


def read(run):
    spans = run.spans or {}
    if "crt.autograd" not in spans or not spans.get("crt.grad_step", {}).get("host_s"):
        return None
    return 100.0 * spans["crt.autograd"]["host_s"] / spans["crt.grad_step"]["host_s"]
