"""The thread-CPU time of the port's `disc_init` phase spans in ms an
object: the host's cost of issuing the init's backbone pass and GN-CG
solve. The span's thread-CPU time stops before the phase's closing
synchronise, which disc_init_ms_per_object's wall time holds."""
from benchmark.metrics._program import per_unit_ms


def read(context):
    return per_unit_ms(context, "disc_init", sum(r["objects"] for r in context["records"]),
                       cpu=True)
