"""``urban_scene``'s procedural city, by the frozen generator of :mod:`portbench.reference.scene`,
with the configuration's ``city`` as its arguments."""

from portbench.reference import scene


def build(config: dict) -> dict:
    return scene.urban_city(**config["city"])
