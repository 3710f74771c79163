"""Seconds from the process's start to the first timed call: imports, kernel library, scene, BVH, inputs, warm-up."""


def read(window: dict) -> float:
    return window["setup_s"]
