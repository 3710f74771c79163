"""CLI: download and list the Sionna example scenes (a port of ``differt_tpu.io.__main__``).

The same commands, arguments and output lines as the JAX package's
``download-sionna-scenes``, installed as ``download-sionna-scenes-torch``::

    python -m differt_tpu_torch.io download [--folder DIR] [--branch REF] [--no-cache]
    python -m differt_tpu_torch.io list [--folder DIR]
    python -m differt_tpu_torch.io path SCENE_NAME [--folder DIR]
"""

import argparse
import sys

from ._sionna import download_sionna_scenes, get_sionna_scene, list_sionna_scenes


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="differt_tpu_torch.io")
    sub = parser.add_subparsers(dest="command", required=True)

    p_download = sub.add_parser("download", help="Download the Sionna scenes")
    p_download.add_argument("--folder", default=None)
    p_download.add_argument("--branch", default="main")
    p_download.add_argument("--no-cache", action="store_true", help="Force re-download")

    p_list = sub.add_parser("list", help="List cached scene names")
    p_list.add_argument("--folder", default=None)

    p_path = sub.add_parser("path", help="Print the XML path of a scene")
    p_path.add_argument("scene_name")
    p_path.add_argument("--folder", default=None)

    args = parser.parse_args(argv)

    if args.command == "download":
        print(download_sionna_scenes(args.branch, folder=args.folder, cached=not args.no_cache))
    elif args.command == "list":
        for name in list_sionna_scenes(args.folder):
            print(name)
    elif args.command == "path":
        print(get_sionna_scene(args.scene_name, folder=args.folder))
    return 0


if __name__ == "__main__":
    sys.exit(main())
