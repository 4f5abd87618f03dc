# StereoScene's trunk with OccFormer's query-based occupancy head, a config
# of the PyTorch port only (the JAX package has no such model).
#
# The trunk is stereoscene_semantickitti.py's, unchanged up to the voxel
# encoder: EfficientNet-b7 + SECONDFPN over both eyes, the stereo volume,
# DepthNet, the MIE and LSS into 128x128x16 voxels. The voxel pyramid takes
# OccFormer's stage widths (projects/configs/occformer_kitti/
# occformer_kitti.py in github.com/zhangyp15/OccFormer) on StereoScene's
# ResNet3D-18: 128x128x16, 64x64x8, 32x32x4 and 16x16x2. The head is
# OccFormer's Mask2Former head straight on that pyramid (no voxel neck) at
# that file's widths: feat_channels = voxel_out_channels = 192, the pixel
# decoder's deformable attention with 8 heads, 4 points and 3 levels (the
# three coarsest, with an FPN fuse to the finest) and an FFN of 4 x 192,
# 6 layers; 100 queries through 9 post-norm masked-attention decoder layers
# over those three levels round-robin, with 192 // 32 = 6 heads and an FFN
# of 8 x 192; the 3D sine encoding at 192 / 3 = 64 channels an axis; mask
# classification with 20 classes plus no-object. The class map is
# OccFormer's test path: the mask logits upsampled trilinearly to the
# 256x256x32 label grid, the sum over the queries of P(class) x
# sigmoid(mask), then argmax.
#
# It serves and evaluates (tools/test.py); training it is not supported
# yet (engine.train.create_train_state refuses the head).

_base_ = ['./stereoscene_semantickitti.py']

voxel_channels = [128, 256, 512, 1024]
voxel_strides = [1, 2, 2, 2]
voxel_out_indices = (0, 1, 2, 3)
norm_cfg = dict(type='GN', num_groups=32, requires_grad=True)
num_class = 20
mask2former_feat_channel = 192

model = dict(
    img_bev_encoder_backbone=dict(
        num_stage=4,
        block_inplanes=voxel_channels,
        block_strides=voxel_strides,
        out_indices=voxel_out_indices,
    ),
    img_bev_encoder_neck=None,
    pts_bbox_head=dict(
        _delete_=True,
        type='Mask2FormerOccHead',
        in_channels=voxel_channels,
        feat_channels=mask2former_feat_channel,
        num_queries=100,
        num_occupancy_classes=num_class,
        # the pixel decoder's deformable attention, and the query decoder's
        num_heads=8,
        num_decoder_heads=mask2former_feat_channel // 32,
        # the deformable encoder's levels (the coarsest three) and the
        # decoder's memories, attended round-robin
        num_feat_levels=3,
        num_encoder_layers=6,
        num_decoder_layers=9,
        feedforward_channels=mask2former_feat_channel * 8,
    ),
)
