"""A generated BAL problem as the port's Problem: Snavely cameras (9
parameters, angle-axis rotation) and points (3) under the configuration's
Huber loss, built by ceres_tpu_torch.build_ba_problem."""


def build(ct, gen, config):
    """(problem, [(handles, start values [n, k])]): the Problem and, for
    each kind of parameter block, its blocks' handles and start values, in
    the order the configuration's reference takes them."""
    bal = ct.BalProblem(gen.cameras.copy(), gen.points.copy(), gen.camera_index,
                        gen.point_index, gen.observations)
    problem, cameras, points = ct.build_ba_problem(
        bal, loss=ct.HuberLoss(float(config["huber_a"])))
    return problem, [(cameras, gen.cameras), (points, gen.points)]
