from scpp_tpu_torch.models.rocket_quat import RocketQuat, RocketQuatParams  # noqa: F401
