from ._artifact import Artifact, VideoArtifact
