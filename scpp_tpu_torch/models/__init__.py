from scpp_tpu_torch.models.rocket2d import Rocket2D, Rocket2DParams  # noqa: F401
from scpp_tpu_torch.models.rocket_quat import RocketQuat, RocketQuatParams  # noqa: F401
