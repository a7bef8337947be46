from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full"]
