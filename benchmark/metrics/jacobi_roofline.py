"""jacobi_roofline.<suffix>: percent of its roofline that the Jacobi
eigensolver kernel reaches over the window, as ``thomas_roofline``."""

from roofline import jacobi_bound_s


def read(rec):
    if rec.device is None or rec.launches is None or not rec.launches.jacobi:
        return None
    seconds, count = rec.device.kernel_seconds("jacobi")
    if count != len(rec.launches.jacobi) or seconds <= 0:
        return None
    return 100.0 * sum(jacobi_bound_s(*s) for s in rec.launches.jacobi) / seconds
