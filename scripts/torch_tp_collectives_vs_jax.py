"""The collectives of one step on the 16x16 layout, the JAX dryrun's
(GSPMD's, parsed from the compiled HLO by `repro.launch.dryrun.
collective_stats`) beside the port's (the tensor-parallel step counted on
meta by `repro_torch.launch.dryrun.counted_collectives`), for an
architecture's `reduced()` config on the CPU. A record, not a check: the
two partitioners choose their own collectives.

    PYTHONPATH=src JAX_PLATFORMS=cpu python \\
        scripts/torch_tp_collectives_vs_jax.py minitron-4b prefill_32k

Prints one JSON line {"arch", "shape", "config", "jax", "port"}. The
JAX side compiles the reduced step on the 16x16 mesh of the host devices
its dryrun forces (a few seconds to half a minute); the port's runs on a
fake process group of 256 ranks.
"""
import json
import sys


def main(argv):
    arch, shape = argv
    # the JAX dryrun sets its device count when imported, before jax
    from repro.launch import dryrun as jdr
    from repro_torch import configs
    from repro_torch.launch import dryrun
    real = jdr.get_config
    jdr.get_config = lambda a: real(a).reduced()
    jax_coll = jdr.dryrun_one(arch, shape, verbose=False)["collectives"]
    port = dryrun.counted_collectives(configs.get_config(arch).reduced(),
                                      configs.SHAPES[shape],
                                      dryrun.make_production_mesh())
    print(json.dumps({"arch": arch, "shape": shape, "config": "reduced",
                      "jax": jax_coll, "port": port}))


if __name__ == "__main__":
    main(sys.argv[1:])
