"""to_card_s: seconds of the network's upload in set-up
(`convert.problem_to_torch`, for the covariance also `engine.fm_problem`
and the state), synchronised."""


def read(run):
    return run.spans.get("to_card_s")
