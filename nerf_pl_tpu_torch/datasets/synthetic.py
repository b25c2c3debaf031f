"""Write the repository's small synthetic Blender scene (a shaded sphere;
12 train, 2 val and 2 test views of 40x40) for a quick run of the port's
CLIs:

    python -m nerf_pl_tpu_torch.datasets.synthetic DIR

The generator is the host code both packages share,
`nerf_pl_tpu.utils.synthetic` (numpy and PIL, no jax), imported when the
scene is written.
"""
import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", help="directory to write the scene into")
    args = parser.parse_args(argv)
    from nerf_pl_tpu.utils.synthetic import make_blender_scene
    root = make_blender_scene(args.root, n_train=12, n_val=2, n_test=2,
                              wh=(40, 40))
    print(root)
    return root


if __name__ == "__main__":
    main()
