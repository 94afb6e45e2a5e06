from pigeon_tpu_torch.runtime import loop, transport
from pigeon_tpu_torch.runtime.loop import (ControllerRuntime, FromAutobox,
                                           ToAutobox)
