"""bake_s: seconds of the program's ``RenderScene.build`` on the device, BVH
included (the harness's clock around the call, synchronised)."""


def read(run):
    return run.bake_s
