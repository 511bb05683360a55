"""On-disk scene naming (a copy of vipnerf_tpu/utils/naming.py): scene-number
datasets (RealEstate10K, DTU) pad the number to 5 digits, name-keyed ones
(NeRF-LLFF) use the name as it is."""


def scene_dirname(scene_id, scene_key: str = "scene_name") -> str:
    """Directory name of a scene under database_data/ and the run trees."""
    if scene_key == "scene_num":
        return f"{int(scene_id):05}"
    return str(scene_id)
