"""Device kernels launched from inside ``Engine.step`` spans per step,
in the traced slice."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["spans"].get("pb.step"):
        return None
    return t["kernels"].get("pb.step", 0) / t["spans"]["pb.step"]
