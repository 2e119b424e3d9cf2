"""Drop-in alias for the reference's launch module.

The reference is started as ``python3 -m dtds.distributed -ip <ip> -rank 0
-epochs 500 -world_size 3 -datapath ...`` (reference README.md:10).  This
module makes the same line work with only the package name changed:
``python -m fed_tgan_torch.distributed <same flags>`` forwards to the CLI,
which accepts every reference flag (``-rank``, ``-ip``, ``-port``,
``-world_size``, ``-epochs``, ``-datapath``, ``-categorical_list``,
``-nonnegative_list``, ``-date_dic``, ``-target_column``,
``-selected_variables``, ``-problem_type``).
"""

from fed_tgan_torch.cli import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
