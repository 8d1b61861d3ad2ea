# Submodules are imported directly (repro_torch.models.api etc.); keep this
# __init__ minimal to avoid configs<->models import cycles.
