"""Print the supported configuration keywords.

    python -m larndsim_tpu_torch.cli.list_config_keys
"""
from ..config import list_config_keys


def main():
    print(list(list_config_keys()))


if __name__ == '__main__':
    main()
